// The row-separable losses of the fused-gradient kernels
// (fused_grad_multi.cu, fused_grad_bsr_multi.cu):
// fusedgrad.py:row_loss_elem in f32, one row at a time; and what the two
// multi-slot kernels share: the slot chunks, the loss sums and the second
// pass over the per-block partials.
#pragma once

namespace {

enum Loss { LOSS_QUAD = 0, LOSS_LOGISTIC = 1, LOSS_HUBER = 2, LOSS_POISSON = 3 };

// (w l(z, t), w l'(z, t)): fusedgrad.py:row_loss_elem, in f32.
__device__ __forceinline__ void row_loss(int loss, float param, float z,
                                         float t, float w, float* le,
                                         float* r) {
  if (loss == LOSS_QUAD) {
    const float d = z - t;
    *le = 0.5f * w * d * d;
    *r = w * d;
  } else if (loss == LOSS_LOGISTIC) {
    const float mz = -t * z;
    *le = w * (fmaxf(mz, 0.f) + log1pf(expf(-fabsf(mz))));  // logaddexp(0, mz)
    *r = w * (-t) * (1.f / (1.f + expf(-mz)));              // sigmoid(mz)
  } else if (loss == LOSS_HUBER) {
    const float d = z - t;
    const float a = fabsf(d);
    *le = w * (a <= param ? 0.5f * d * d : param * (a - 0.5f * param));
    *r = w * fminf(fmaxf(d, -param), param);
  } else {
    const float ez = expf(z);
    *le = w * (ez - t * z);
    *r = w * (ez - t);
  }
}

// The multi-slot kernels run the slots in chunks of KC over each staged
// tile.  KC is a constant, never derived from the slot count; a chunk's
// live slots, rounded up to 1, 2, 4 or 8 (its width class), pick which
// compiled variant computes them, never how.
constexpr int KC = 8;

__host__ __device__ inline int width_class(int live) {
  return live > 4 ? 8 : live > 2 ? 4 : live;
}

// A slot's loss sum belongs to thread slot % THREADS: a compensated sum
// (kahan_add, common.cuh), in registers (fr, fc) for the first THREADS
// slots, in the block's f_part slice (f_blk[slot], f_blk[k + slot]) past
// them.  In a chunk of slots c0.., that thread sums the slot's losses of
// the tile (les[p][i], row stride ld) over the rows in order, then adds
// that tile sum to the block's: so f stays within a few roundings of the
// exact sum however many rows one block walks.
template <int THREADS>
__device__ __forceinline__ void add_losses(float& fr, float& fc,
                                           float* __restrict__ f_blk, int k,
                                           const float* __restrict__ les,
                                           int ld, int rows, int c0,
                                           int live) {
  const int p = (int)threadIdx.x - c0 % THREADS;
  if (p < 0 || p >= live) return;
  const int slot = c0 + p;
  const float* lp = les + p * ld;
  float tile = 0.f;
  for (int i = 0; i < rows; ++i) tile += lp[i];
  if (slot < THREADS) {
    kahan_add(fr, fc, tile);
  } else {
    float s = f_blk[slot], c = f_blk[k + slot];
    kahan_add(s, c, tile);
    f_blk[slot] = s;
    f_blk[k + slot] = c;
  }
}

// Zero the block's loss sums (f_blk: 2k floats) past the first THREADS.
template <int THREADS>
__device__ __forceinline__ void zero_losses(float* __restrict__ f_blk,
                                            int k) {
  for (int s = threadIdx.x + THREADS; s < k; s += THREADS)
    f_blk[s] = f_blk[k + s] = 0.f;
}

// The block's loss sums, compensation applied, into f_blk[0..k).
template <int THREADS>
__device__ __forceinline__ void finish_losses(float fr, float fc,
                                              float* __restrict__ f_blk,
                                              int k) {
  for (int s = threadIdx.x; s < k; s += THREADS)
    f_blk[s] = s < THREADS ? fr - fc : f_blk[s] - f_blk[k + s];
}

// Second pass of both multi-slot kernels: G (k x n) and f (k) from the
// per-block partials, in a fixed order over the blocks, with compensation
// (no float atomics).  A block's G slice starts every g_stride floats, its
// f slice every 2k.  A block of the reduction takes kReduceLanes entries
// (G's, then f's): warp q sums the q-th of kReduceSplits runs of
// consecutive blocks' partials, and warp 0 then adds the runs in order, so
// a small G still keeps many loads in flight.  The runs follow from the
// partial count alone.
constexpr int kReduceLanes = 32;
constexpr int kReduceSplits = 8;
constexpr int kReduceThreads = kReduceLanes * kReduceSplits;

__global__ void __launch_bounds__(kReduceThreads)
multi_reduce(const float* __restrict__ g_part,
             const float* __restrict__ f_part, int parts, int k, int n,
             long long g_stride, float* __restrict__ g,
             float* __restrict__ f) {
  __shared__ float runs[kReduceSplits][kReduceLanes];
  const int lane = threadIdx.x % kReduceLanes;
  const int run = threadIdx.x / kReduceLanes;
  const long long kn = (long long)k * n;
  const long long e = (long long)blockIdx.x * kReduceLanes + lane;
  const float* p = nullptr;
  long long stride = 0;
  if (e < kn) {
    p = g_part + e;
    stride = g_stride;
  } else if (e < kn + k) {
    p = f_part + (e - kn);
    stride = 2LL * k;
  }
  float s = 0.f, c = 0.f;
  if (p != nullptr) {
    const int b1 = (int)((long long)(run + 1) * parts / kReduceSplits);
#pragma unroll 4
    for (int b = (int)((long long)run * parts / kReduceSplits); b < b1; ++b)
      kahan_add(s, c, p[b * stride]);
  }
  runs[run][lane] = s - c;
  __syncthreads();
  if (run == 0 && p != nullptr) {
    float t = 0.f, tc = 0.f;
#pragma unroll
    for (int q = 0; q < kReduceSplits; ++q) kahan_add(t, tc, runs[q][lane]);
    if (e < kn) g[e] = t - tc;
    else f[e - kn] = t - tc;
  }
}

// The launch of multi_reduce for k slots of n columns.
inline void launch_multi_reduce(const float* g_part, const float* f_part,
                                int parts, int k, int n, long long g_stride,
                                float* g, float* f, cudaStream_t stream) {
  const long long entries = (long long)k * n + k;
  const unsigned blocks =
      (unsigned)((entries + kReduceLanes - 1) / kReduceLanes);
  multi_reduce<<<blocks, kReduceThreads, 0, stream>>>(
      g_part, f_part, parts, k, n, g_stride, g, f);
}

}  // namespace

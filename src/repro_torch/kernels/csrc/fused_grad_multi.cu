// Fused composite gradient for k right-hand sides (slots) sharing one
// design matrix: one read of A gives
//   f_s = sum_i W_si l((A X_s)_i, T_si),  G_s = A^T (W_s o l'(A X_s, T_s)),
//   Z_s = A X_s                                       for every slot s < k.
//
// Replaces both TPU kernels of src/repro/kernels/fusedgrad.py: fused_grad
// (_fused_grad_kernel) is the case k = 1, fused_grad_multi
// (_fused_grad_multi_kernel) the request-batched form.  Bandwidth-bound on
// the H100 for small k: 4mnk f32 FMA flops against m*n*sizeof(storage)
// bytes of A plus 12mk bytes of T, W and Z.  At n = 1024, 67 TFLOP/s and
// 3.35 TB/s the operations pass the bytes near k = 21.2 in f32 storage and,
// counting the f32 FMAs the kernel does, k = 10.6 in bf16 storage.
//
// Design.  The TPU kernels walk row blocks on a sequential grid and carry
// G and f in VMEM scratch.  Here a persistent grid of kBlocksPerSM blocks
// per SM walks row blocks of `bm` rows, a multiple of the warp count, with
// a block stride.  Each row block is read from HBM once:
//   * staged path (bm*n floats fit kTileBudget): the block is copied into
//     shared memory as f32 and both sweeps read it there;
//   * unstaged path (wide n): both sweeps read the block from global memory
//     (the second finds it in L2).
// The block's G accumulator (k x n) lives in shared memory when it fits
// beside the tile (unstaged: only while six blocks still fit an SM), else
// in this block's own slice of the partials buffer.
// Sweep 1: one warp per row keeps KMAX dot products (one per slot) in
// registers, lane-strided over the columns, then a butterfly reduce; lane s
// evaluates slot s's loss.  Sweep 2: one thread per column keeps KMAX
// accumulators and adds R_blk[i, s] * A_blk[i, j] row by row.
// Slot independence: bm and the grid follow from (m, n) and the card
// alone, never from k, and every slot's z, f and g is a sum in an order
// fixed by them, so a slot's bits depend neither on the other slots'
// values nor on how many slots there are: a request gets the same bits
// alone (fused_grad) or in a group.  Per-block partials of G and f are
// summed in block order by a second kernel (no float atomics), so repeated
// runs agree bit for bit.  Ragged m, n and k are masked, not padded: KMAX
// is the next power of two >= k and lanes s >= k are skipped.
#include "common.cuh"
#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;
constexpr int kTileBudget = 32 * 1024;   // the staged row block, f32
constexpr int kSmemBudget = 200 * 1024;  // tile + G + residuals
constexpr int kBlocksPerSM = 6;        // whole waves at 1, 2 or 3 blocks an SM
// The unstaged path keeps G in shared memory only while kBlocksPerSM
// blocks still fit an SM: there the blocks in flight hide the latency of
// the global loads (tools/time_fused_grad.py on an H100 80GB HBM3 at 700 W,
// 2^18 x 16384, one slot: 14.4-15.4 ms f32 and 12.8-12.9 ms bf16 with G in
// shared memory at three blocks an SM, 12.1 and 7.3 ms with G in global).
constexpr int kUnstagedSmem = 36 * 1024;

// G_SMEM is a template parameter, not a run-time flag: a pointer that may
// point to shared or global memory compiles to generic loads and stores
// (chip_smoke.py on an H100 80GB HBM3 at 700 W, 2^21 x 1024 f32, k = 8:
// 31.6 ms with the run-time flag, 13.2 ms with the template).
template <typename T, int KMAX, bool STAGED, bool G_SMEM>
__global__ void __launch_bounds__(kThreads)
fgm_partials(const T* __restrict__ a, const float* __restrict__ x,
             const float* __restrict__ t, const float* __restrict__ w,
             long long m, int n, int k, int bm, int loss, float param,
             float* __restrict__ z, float* __restrict__ g_part,
             float* __restrict__ f_part) {
  // Shared layout: tile[bm * n] (STAGED only) | g[k * n] (G_SMEM only) |
  // r[bm * KMAX].  Without G_SMEM, g is this block's slice of g_part.
  extern __shared__ float smem[];
  __shared__ float f_warp[kWarps][KMAX];
  float* tile = smem;
  float* after_tile = smem + (STAGED ? (size_t)bm * n : 0);
  float* g_acc = G_SMEM ? after_tile : g_part + (size_t)blockIdx.x * k * n;
  float* r_s = G_SMEM ? after_tile + (size_t)k * n : after_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < k * n; e += kThreads) g_acc[e] = 0.f;
  float f_acc = 0.f;  // lane s < k of each warp: slot s's loss of its rows

  for (long long r0 = (long long)blockIdx.x * bm; r0 < m;
       r0 += (long long)gridDim.x * bm) {
    const int rows = (int)min((long long)bm, m - r0);
    const T* blk = a + r0 * n;
    if (STAGED) {
      const int count = rows * n;
      for (int e = tid; e < count; e += kThreads) tile[e] = to_f32(blk[e]);
      __syncthreads();
    }
    // Sweep 1: Z_blk = X A_blk^T, one warp per row, KMAX sums per lane.
    for (int i = warp; i < rows; i += kWarps) {
      float acc[KMAX];
#pragma unroll
      for (int s = 0; s < KMAX; ++s) acc[s] = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float v = STAGED ? tile[i * n + j]
                               : to_f32(blk[(size_t)i * n + j]);
#pragma unroll
        for (int s = 0; s < KMAX; ++s)
          if (s < k) acc[s] = fmaf(v, __ldg(x + (size_t)s * n + j), acc[s]);
      }
#pragma unroll
      for (int s = 0; s < KMAX; ++s)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
      // Every lane now holds all KMAX sums; lane s takes slot s.
      float mine = 0.f;
#pragma unroll
      for (int s = 0; s < KMAX; ++s)
        if (s == lane) mine = acc[s];
      float r = 0.f;
      if (lane < k) {
        const long long idx = (long long)lane * m + r0 + i;
        float le;
        row_loss(loss, param, mine, t[idx], w[idx], &le, &r);
        z[idx] = mine;
        f_acc += le;
      }
      if (lane < KMAX) r_s[i * KMAX + lane] = r;   // 0 for lanes >= k
    }
    __syncthreads();
    // Sweep 2: G_s += R_blk[:, s] A_blk, one thread per column.
    for (int j = tid; j < n; j += kThreads) {
      float acc[KMAX];
#pragma unroll
      for (int s = 0; s < KMAX; ++s)
        acc[s] = s < k ? g_acc[(size_t)s * n + j] : 0.f;
      for (int i = 0; i < rows; ++i) {
        const float v = STAGED ? tile[i * n + j]
                               : to_f32(blk[(size_t)i * n + j]);
#pragma unroll
        for (int s = 0; s < KMAX; ++s)
          acc[s] = fmaf(r_s[i * KMAX + s], v, acc[s]);
      }
#pragma unroll
      for (int s = 0; s < KMAX; ++s)
        if (s < k) g_acc[(size_t)s * n + j] = acc[s];
    }
    __syncthreads();  // the next row block overwrites tile and r_s
  }

  if (G_SMEM)
    for (int e = tid; e < k * n; e += kThreads)
      g_part[(size_t)blockIdx.x * k * n + e] = g_acc[e];
  if (lane < KMAX) f_warp[warp][lane] = f_acc;
  __syncthreads();
  if (tid < k) {
    float f = 0.f;
    for (int q = 0; q < kWarps; ++q) f += f_warp[q][tid];
    f_part[(size_t)blockIdx.x * k + tid] = f;
  }
}

// Second pass: sum the per-block partials of G (k x n) and f (k) in block
// order.
__global__ void fgm_reduce(const float* __restrict__ g_part,
                           const float* __restrict__ f_part, int parts,
                           int k, int n, float* __restrict__ g,
                           float* __restrict__ f) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kn = (long long)k * n;
  if (e < kn) {
    float s = 0.f;
    for (int b = 0; b < parts; ++b) s += g_part[(size_t)b * kn + e];
    g[e] = s;
  }
  if (e < k) {
    float s = 0.f;
    for (int b = 0; b < parts; ++b) s += f_part[(size_t)b * k + e];
    f[e] = s;
  }
}

template <typename T, int KMAX>
const void* kernel_kmax(int staged, int g_smem) {
  if (staged)
    return g_smem ? (const void*)&fgm_partials<T, KMAX, true, true>
                  : (const void*)&fgm_partials<T, KMAX, true, false>;
  return g_smem ? (const void*)&fgm_partials<T, KMAX, false, true>
                : (const void*)&fgm_partials<T, KMAX, false, false>;
}

template <typename T>
const void* kernel_dtype(int kmax, int staged, int g_smem) {
  switch (kmax) {
    case 1: return kernel_kmax<T, 1>(staged, g_smem);
    case 2: return kernel_kmax<T, 2>(staged, g_smem);
    case 4: return kernel_kmax<T, 4>(staged, g_smem);
    case 8: return kernel_kmax<T, 8>(staged, g_smem);
    case 16: return kernel_kmax<T, 16>(staged, g_smem);
    case 32: return kernel_kmax<T, 32>(staged, g_smem);
    default: return nullptr;
  }
}

const void* kernel_for(int dtype, int kmax, int staged, int g_smem) {
  return dtype == DT_BF16
             ? kernel_dtype<__nv_bfloat16>(kmax, staged, g_smem)
             : kernel_dtype<float>(kmax, staged, g_smem);
}

int kmax_for(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

size_t smem_bytes(int n, int k, int kmax, int bm, int staged, int g_smem) {
  return ((staged ? (size_t)bm * n : 0) + (g_smem ? (size_t)k * n : 0)
          + (size_t)bm * kmax) * 4;
}

}  // namespace

// Row-block height, paths and grid for an (m x n) operand and k slots on
// `device`.  bm, the staged path and the grid follow from (m, n) and the
// card alone, so a slot's sums run in the same order for every k; only
// where G accumulates (shared memory when it fits) depends on k.
extern "C" int repro_fused_grad_multi_plan(int device, long long m, int n,
                                           int k, int dtype, int* bm,
                                           int* staged, int* g_smem,
                                           int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int kmax = kmax_for(k);
  if (k < 1 || kmax > 32) return cudaErrorInvalidValue;
  int rows = kTileBudget / 4 / n;
  *staged = rows >= kWarps;
  rows = rows < kMaxRows ? rows : kMaxRows;
  *bm = *staged ? rows / kWarps * kWarps : kMaxRows;
  const size_t with_g = smem_bytes(n, k, kmax, *bm, *staged, 1);
  *g_smem = with_g <= (size_t)kSmemBudget
            && (*staged || with_g <= (size_t)kUnstagedSmem);
  const size_t smem = smem_bytes(n, k, kmax, *bm, *staged, *g_smem);
  const void* fn = kernel_for(dtype, kmax, *staged, *g_smem);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, occ = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = (m + *bm - 1) / *bm;
  long long g = (long long)sms * kBlocksPerSM;
  if (blocks < g) g = blocks;
  *grid = g < 1 ? 1 : (int)g;
  return cudaSuccess;
}

extern "C" int repro_fused_grad_multi(int device, const void* a, int dtype,
                                      const void* x, const void* t,
                                      const void* w, long long m, int n,
                                      int k, int bm, int staged,
                                      int g_smem, int grid, int loss,
                                      float param, void* z,
                                      void* g_part, void* f_part, void* g,
                                      void* f, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int kmax = kmax_for(k);
  if (k < 1 || kmax > 32) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, k, kmax, bm, staged, g_smem);
  const void* fn = kernel_for(dtype, kmax, staged, g_smem);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long mm = m;
  int nn = n, kk = k, bmm = bm, ll = loss;
  float pp = param;
  void* args[] = {const_cast<void**>(&a), const_cast<void**>(&x),
                  const_cast<void**>(&t), const_cast<void**>(&w), &mm, &nn,
                  &kk, &bmm, &ll, &pp, &z, &g_part, &f_part};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kn = (long long)k * n;
  const unsigned rblocks = (unsigned)((kn + kThreads - 1) / kThreads);
  fgm_reduce<<<rblocks, kThreads, 0, s>>>(
      static_cast<const float*>(g_part), static_cast<const float*>(f_part),
      grid, k, n, static_cast<float*>(g), static_cast<float*>(f));
  return cudaGetLastError();
}

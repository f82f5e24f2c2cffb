// Fused composite gradient for k right-hand sides (slots) sharing one
// block-ELL A (nbr block-rows of `ell` stored bs x bs blocks, block-column
// ids in cols[nbr][ell]): one read of the stored blocks gives, for every
// slot s < k,
//   f_s = sum_i W_si l((A X_s)_i, T_si),  G_s = A^T (W_s o l'(A X_s, T_s)),
//   Z_s = A X_s.
//
// Replaces the TPU kernel src/repro/kernels/fusedgrad.py:fused_grad_bsr_multi
// (_fused_grad_bsr_multi_kernel): the serving path's group pass on a sparse
// design matrix (core/optim/batched over SparseRowMatrix).  For a few slots
// it is bound by bytes on the H100: every stored block is read once
// (nbr*ell*bs*bs*sizeof(storage)) for 4k flops an element, plus X, T, W, Z
// and G; in f32 FMA at 67 TFLOP/s and 3.35 TB/s the operations pass the
// bytes of f32 blocks near k = 20.  Storage is f32 or bf16, upcast in
// registers; the residual stays f32; sums in f32.  int8 shards never come
// here: kernels/ops.py composes bsr_matmul and bsr_rmatmul for them, as the
// reference does.
//
// Design.  The TPU kernel walks block-rows on a sequential grid and
// scatter-adds each (k x bs) slab A_ij^T R into a VMEM-resident
// (nbc x k x bs) accumulator.  Here a persistent grid of kBlocksPerSM
// 256-thread blocks an SM walks block-rows with a grid stride.  A block
// stages a block-row's ell blocks (as f32) and the X slab its columns
// select (k x ell*bs) in shared memory, while both fit their budgets at
// kMaxSlots slots; else it reads both from global memory (the blocks twice,
// the second time from L2).  Then:
//   sweep 1: one warp per row keeps KMAX dot products (one per slot) in
//            registers, lane-strided over the row's ell*bs entries, then a
//            butterfly sum; lane s takes slot s's z, its residual and loss
//            (row_loss.cuh, shared with fused_grad_multi.cu);
//   sweep 2: thread (s, c) alone owns slot s's G entries with in-block
//            offset c: for each slot of the block-row in order it forms
//            sum_r R[s][r] A[slot][r][c] and adds it into the block's
//            partial G at cols[slot]*bs + c, so no atomics are needed even
//            when two slots of a block-row share a column (padding slots
//            sit at column 0).
// G is k x n, too large for shared memory at wide n, so each block keeps
// its partial G in its own slice of g_part (grid x k x n f32); a second
// kernel sums the slices, and the blocks' partial f, in block order.  No
// float atomics.
// Slot independence: the grid and the staging decision follow from A's
// shape and the card alone, never from k, and every slot's z, f and G is a
// sum in an order fixed by them and not by the slot's index, so a slot's
// bits depend neither on the other slots' values, nor on how many slots
// there are, nor on which slot it is: a request gets the same bits alone
// or anywhere in a group, and repeated runs agree bit for bit.
#include "common.cuh"
#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 32;             // fusedgrad.py:MAX_SLOTS
constexpr int kTileBudget = 64 * 1024;    // a staged block-row, f32
constexpr int kXBudget = 64 * 1024;       // its X slab at kMaxSlots, f32
constexpr int kBlocksPerSM = 2;

int kmax_for(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

size_t smem_bytes(int bs, int ell, int k, int kmax, int staged) {
  return ((staged ? (size_t)ell * bs * bs + (size_t)k * ell * bs : 0) +
          (size_t)kmax * bs) * sizeof(float);
}

template <typename T, int BS, int KMAX, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fgbm_partials(const T* __restrict__ data, const int* __restrict__ cols,
              const float* __restrict__ x, const float* __restrict__ t,
              const float* __restrict__ w, long long nbr, int ell, int n,
              int k, int loss, float param, float* __restrict__ z,
              float* __restrict__ g_part, float* __restrict__ f_part) {
  constexpr int kElems = BS * BS;
  constexpr int V = 16 / (int)sizeof(T);
  // Shared layout: tile[ell*BS*BS] | xs[k * ell*BS] (both STAGED only) |
  // res[KMAX * BS].
  extern __shared__ float smem[];
  __shared__ float f_warp[kWarps][KMAX];
  const int width = ell * BS;          // entries in one row of a block-row
  float* tile = smem;
  float* xs = smem + (STAGED ? (size_t)ell * kElems : 0);
  float* res = xs + (STAGED ? (size_t)k * width : 0);
  float* g_acc = g_part + (size_t)blockIdx.x * k * n;
  const long long m = nbr * BS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long long e = tid; e < (long long)k * n; e += kThreads) g_acc[e] = 0.f;
  float f_acc = 0.f;  // lane s < k of each warp: slot s's loss of its rows
  __syncthreads();    // the zeroed slice before any thread adds into it

  for (long long i = blockIdx.x; i < nbr; i += gridDim.x) {
    const T* blk = data + i * ell * kElems;
    const int* ci = cols + i * ell;
    if (STAGED) {
      for (int e = tid * V; e < ell * kElems; e += kThreads * V) {
        float v[V];
        load_vec<T, V>(blk + e, v);
#pragma unroll
        for (int q = 0; q < V; ++q) tile[e + q] = v[q];
      }
      for (int e = tid; e < k * width; e += kThreads) {
        const int s = e / width, j = e - s * width;
        xs[e] = __ldg(x + (size_t)s * n + (size_t)__ldg(ci + j / BS) * BS +
                      j % BS);
      }
      __syncthreads();
    }
    // Sweep 1: Z for each row of the block-row, one warp per row, KMAX
    // sums per lane.
    for (int r = warp; r < BS; r += kWarps) {
      float acc[KMAX];
#pragma unroll
      for (int s = 0; s < KMAX; ++s) acc[s] = 0.f;
      for (int j = lane; j < width; j += 32) {
        const int sl = j / BS, c = j % BS;
        const int idx = (sl * BS + r) * BS + c;
        const float a = STAGED ? tile[idx] : to_f32(blk[idx]);
        if (STAGED) {
#pragma unroll
          for (int s = 0; s < KMAX; ++s)
            if (s < k) acc[s] = fmaf(a, xs[s * width + j], acc[s]);
        } else {
          const float* xc = x + (size_t)__ldg(ci + sl) * BS + c;
#pragma unroll
          for (int s = 0; s < KMAX; ++s)
            if (s < k) acc[s] = fmaf(a, __ldg(xc + (size_t)s * n), acc[s]);
        }
      }
      // Lane s takes slot s: lane 0's sum of the butterfly, broadcast, so
      // a slot's z has the same bits in whichever slot it sits.
      float mine = 0.f;
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
        const float v = __shfl_sync(0xffffffffu, acc[s], 0);
        if (s == lane) mine = v;
      }
      float rr = 0.f;
      if (lane < k) {
        const long long idx = (long long)lane * m + i * BS + r;
        float le;
        row_loss(loss, param, mine, __ldg(t + idx), __ldg(w + idx), &le, &rr);
        z[idx] = mine;
        f_acc += le;
      }
      if (lane < KMAX) res[lane * BS + r] = rr;   // 0 for lanes >= k
    }
    __syncthreads();
    // Sweep 2: G_s[cols[sl]*BS + c] += sum_r R[s][r] A[sl][r][c], the
    // block-row's slots in order, by the one thread that owns (s, c).
    for (int p = tid; p < k * BS; p += kThreads) {
      const int s = p / BS, c = p % BS;
      const float* rs = res + s * BS;
      float* gs = g_acc + (size_t)s * n + c;
      for (int sl = 0; sl < ell; ++sl) {
        float acc = 0.f;
#pragma unroll 8
        for (int r = 0; r < BS; ++r) {
          const int idx = (sl * BS + r) * BS + c;
          const float a = STAGED ? tile[idx] : to_f32(blk[idx]);
          acc = fmaf(rs[r], a, acc);
        }
        gs[(size_t)__ldg(ci + sl) * BS] += acc;
      }
    }
    __syncthreads();   // tile, xs and res are reused next
  }

  if (lane < KMAX) f_warp[warp][lane] = f_acc;
  __syncthreads();
  if (tid < k) {
    float f = 0.f;
    for (int q = 0; q < kWarps; ++q) f += f_warp[q][tid];
    f_part[(size_t)blockIdx.x * k + tid] = f;
  }
}

// Second pass: G (k x n) and f (k) summed over the blocks' partials in
// block order.
__global__ void fgbm_reduce(const float* __restrict__ g_part,
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

template <typename T, int BS, int KMAX>
const void* kernel_staged(int staged) {
  return staged ? (const void*)&fgbm_partials<T, BS, KMAX, true>
                : (const void*)&fgbm_partials<T, BS, KMAX, false>;
}

template <typename T, int BS>
const void* kernel_kmax(int kmax, int staged) {
  switch (kmax) {
    case 1: return kernel_staged<T, BS, 1>(staged);
    case 2: return kernel_staged<T, BS, 2>(staged);
    case 4: return kernel_staged<T, BS, 4>(staged);
    case 8: return kernel_staged<T, BS, 8>(staged);
    case 16: return kernel_staged<T, BS, 16>(staged);
    case 32: return kernel_staged<T, BS, 32>(staged);
    default: return nullptr;
  }
}

template <typename T>
const void* kernel_bs(int bs, int kmax, int staged) {
  switch (bs) {
    case 8: return kernel_kmax<T, 8>(kmax, staged);
    case 16: return kernel_kmax<T, 16>(kmax, staged);
    case 32: return kernel_kmax<T, 32>(kmax, staged);
    case 64: return kernel_kmax<T, 64>(kmax, staged);
    case 128: return kernel_kmax<T, 128>(kmax, staged);
    default: return nullptr;
  }
}

const void* kernel_for(int dtype, int bs, int kmax, int staged) {
  if (dtype == DT_F32) return kernel_bs<float>(bs, kmax, staged);
  if (dtype == DT_BF16) return kernel_bs<__nv_bfloat16>(bs, kmax, staged);
  return nullptr;
}

}  // namespace

// The staged path and the grid for nbr block-rows of `ell` bs x bs blocks
// on `device`: they follow from the shape and the card alone (sized for
// kMaxSlots), never from the slot count.
extern "C" int repro_fused_grad_bsr_multi_plan(int device, long long nbr,
                                               int ell, int bs, int n,
                                               int* staged, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || ell < 1 || bs < 1 || n < bs) return cudaErrorInvalidValue;
  *staged = (size_t)ell * bs * bs * sizeof(float) <= (size_t)kTileBudget &&
            (size_t)kMaxSlots * ell * bs * sizeof(float) <= (size_t)kXBudget;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long g = (long long)sms * kBlocksPerSM;
  *grid = (int)(nbr < g ? nbr : g);
  return cudaSuccess;
}

// data (nbr, ell, bs, bs) f32 or bf16, cols (nbr, ell) int32, x (k, n) f32,
// t, w (k, nbr*bs) f32, 1 <= k <= kMaxSlots; z (k, nbr*bs), g_part
// (grid, k, n), f_part (grid, k), g (k, n) and f (k) f32 outputs and
// scratch.
extern "C" int repro_fused_grad_bsr_multi(int device, const void* data,
                                          int dtype, const void* cols,
                                          const void* x, const void* t,
                                          const void* w, long long nbr,
                                          int ell, int bs, int n, int k,
                                          int staged, int grid, int loss,
                                          float param, void* z, void* g_part,
                                          void* f_part, void* g, void* f,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int kmax = kmax_for(k);
  if (k < 1 || kmax > kMaxSlots || grid < 1) return cudaErrorInvalidValue;
  const void* fn = kernel_for(dtype, bs, kmax, staged);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bs, ell, k, kmax, staged);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long nb = nbr;
  int ee = ell, nn = n, kk = k, ll = loss;
  float pp = param;
  void* args[] = {const_cast<void**>(&data), const_cast<void**>(&cols),
                  const_cast<void**>(&x), const_cast<void**>(&t),
                  const_cast<void**>(&w), &nb, &ee, &nn, &kk, &ll, &pp, &z,
                  &g_part, &f_part};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kn = (long long)k * n;
  const unsigned rblocks = (unsigned)((kn + kThreads - 1) / kThreads);
  fgbm_reduce<<<rblocks, kThreads, 0, s>>>(
      static_cast<const float*>(g_part), static_cast<const float*>(f_part),
      grid, k, n, static_cast<float*>(g), static_cast<float*>(f));
  return cudaGetLastError();
}

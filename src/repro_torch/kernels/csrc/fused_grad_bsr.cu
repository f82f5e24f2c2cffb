// Fused composite gradient on a block-ELL A (nbr block-rows of `ell` stored
// bs x bs blocks, block-column ids in cols[nbr][ell]): one read of the
// stored blocks gives
//   f = sum_i w_i l((A x)_i, t_i),  g = A^T (w o l'(A x, t)),  z = A x.
//
// Replaces the TPU kernel src/repro/kernels/fusedgrad.py:fused_grad_bsr
// (_fused_grad_bsr_kernel).  Bound by bytes on the H100: every stored block
// is read once (nbr*ell*bs*bs*sizeof(storage)) for 4 flops an element, plus
// x, t, w, z and g.  Storage is f32 or bf16, upcast in registers; the
// residual stays f32; sums in f32.  int8 shards never come here:
// kernels/ops.py composes bsr_matvec and bsr_rmatmul for them, as the
// reference does.
//
// Design.  The TPU kernel walks block-rows on a sequential grid and
// scatter-adds A_ij^T r into a VMEM-resident (nbc x bs) accumulator.  Here
// a persistent grid (as many 256-thread blocks as fit the card at once)
// walks block-rows with a grid stride.  Each block stages a block-row's
// ell blocks in shared memory once (while they fit 64 KB; else it reads
// them from global memory twice, the second time from L2) and sweeps them
// twice:
//   sweep 1: one warp per row forms z (lanes over the row's ell*bs
//            entries, x gathered at each slot's column, a butterfly sum),
//            then the residual r = w o l'(z, t) and the loss (row_loss.cuh,
//            shared with fused_grad_multi.cu);
//   sweep 2: all threads form the contributions r^T A_ij of up to 2048/bs
//            slots at a time, then thread c < bs adds them, slot by slot in
//            order, into the block's partial g at col*bs + c.  Thread c is
//            the only one that touches g entries with in-block offset c, so
//            the read-modify-write needs no atomics even when two slots of
//            a row share a column (padding slots sit at column 0).
// The partial g lives in shared memory while it fits beside the tile with
// two blocks an SM, else in this block's slice of g_part.  A second kernel
// sums the blocks' partials of g and f in block order.  The grid follows
// from the shape and the card alone, so runs repeat bit for bit.  No n is
// refused: the reference's fallback to matvec + rmatmul for an n too wide
// for VMEM has no counterpart here.
#include "common.cuh"
#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBudget = 64 * 1024;     // a staged block-row, f32
constexpr int kContrib = 2048;             // sweep-2 contributions, f32
constexpr int kGSmemBudget = 112 * 1024;   // g in smem: two blocks an SM

size_t smem_bytes(int bs, int ell, int n, int staged, int g_smem) {
  return ((staged ? (size_t)ell * bs * bs : 0) + (g_smem ? (size_t)n : 0) +
          bs + kContrib) * sizeof(float);
}

template <typename T, int BS, bool STAGED, bool G_SMEM>
__global__ void __launch_bounds__(kThreads)
fgb_partials(const T* __restrict__ data, const int* __restrict__ cols,
             const float* __restrict__ x, const float* __restrict__ t,
             const float* __restrict__ w, long long nbr, int ell, int n,
             int loss, float param, float* __restrict__ z,
             float* __restrict__ g_part, float* __restrict__ f_part) {
  constexpr int kElems = BS * BS;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kSlotsPerBatch = kContrib / BS;
  // Shared layout: tile[ell*BS*BS] (STAGED) | g[n] (G_SMEM) | res[BS] |
  // contrib[kContrib].
  extern __shared__ float smem[];
  __shared__ float f_warp[kWarps];
  float* tile = smem;
  float* after = smem + (STAGED ? (size_t)ell * kElems : 0);
  float* g_acc = G_SMEM ? after : g_part + (size_t)blockIdx.x * n;
  float* res = G_SMEM ? after + n : after;
  float* contrib = res + BS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < n; e += kThreads) g_acc[e] = 0.f;
  float f_acc = 0.f;   // lane 0 of each warp: the loss of its rows
  __syncthreads();

  for (long long i = blockIdx.x; i < nbr; i += gridDim.x) {
    const T* blk = data + i * ell * kElems;
    const int* ci = cols + i * ell;
    if (STAGED) {
      for (int e = tid * V; e < ell * kElems; e += kThreads * V) {
        float v[V];
        load_vec<T, V>(blk + e, v);
#pragma unroll
        for (int k = 0; k < V; ++k) tile[e + k] = v[k];
      }
      __syncthreads();
    }
    // Sweep 1: z for each row of the block-row, one warp per row.
    for (int r = warp; r < BS; r += kWarps) {
      float acc = 0.f;
      for (int e = lane; e < ell * BS; e += 32) {
        const int s = e / BS, c = e % BS;
        const int idx = (s * BS + r) * BS + c;
        const float a = STAGED ? tile[idx] : to_f32(blk[idx]);
        acc = fmaf(a, __ldg(x + (long long)__ldg(ci + s) * BS + c), acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const long long row = i * BS + r;
        float le, rr;
        row_loss(loss, param, acc, __ldg(t + row), __ldg(w + row), &le, &rr);
        z[row] = acc;
        res[r] = rr;
        f_acc += le;
      }
    }
    __syncthreads();
    // Sweep 2: g[col*BS + c] += sum_r res[r] A[s][r][c], slots in order.
    for (int s0 = 0; s0 < ell; s0 += kSlotsPerBatch) {
      const int nb = min(kSlotsPerBatch, ell - s0);
      for (int e = tid; e < nb * BS; e += kThreads) {
        const int s = s0 + e / BS, c = e % BS;
        float acc = 0.f;
        for (int r = 0; r < BS; ++r) {
          const int idx = (s * BS + r) * BS + c;
          const float a = STAGED ? tile[idx] : to_f32(blk[idx]);
          acc = fmaf(res[r], a, acc);
        }
        contrib[e] = acc;
      }
      __syncthreads();
      if (tid < BS)
        for (int sl = 0; sl < nb; ++sl) {
          const long long g_idx = (long long)__ldg(ci + s0 + sl) * BS + tid;
          g_acc[g_idx] += contrib[sl * BS + tid];
        }
      __syncthreads();   // contrib, res and the tile are reused next
    }
  }

  if (G_SMEM)
    for (int e = tid; e < n; e += kThreads)
      g_part[(size_t)blockIdx.x * n + e] = g_acc[e];
  if (lane == 0) f_warp[warp] = f_acc;
  __syncthreads();
  if (tid == 0) {
    float f = 0.f;
    for (int q = 0; q < kWarps; ++q) f += f_warp[q];
    f_part[blockIdx.x] = f;
  }
}

// Second pass: g and f summed over the blocks' partials in block order.
__global__ void fgb_reduce(const float* __restrict__ g_part,
                           const float* __restrict__ f_part, int parts, int n,
                           float* __restrict__ g, float* __restrict__ f) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) {
    float s = 0.f;
    for (int b = 0; b < parts; ++b) s += g_part[(size_t)b * n + e];
    g[e] = s;
  }
  if (e == 0) {
    float s = 0.f;
    for (int b = 0; b < parts; ++b) s += f_part[b];
    *f = s;
  }
}

template <typename T, int BS>
const void* kernel_paths(int staged, int g_smem) {
  if (staged)
    return g_smem ? (const void*)&fgb_partials<T, BS, true, true>
                  : (const void*)&fgb_partials<T, BS, true, false>;
  return g_smem ? (const void*)&fgb_partials<T, BS, false, true>
                : (const void*)&fgb_partials<T, BS, false, false>;
}

template <typename T>
const void* kernel_bs(int bs, int staged, int g_smem) {
  switch (bs) {
    case 8: return kernel_paths<T, 8>(staged, g_smem);
    case 16: return kernel_paths<T, 16>(staged, g_smem);
    case 32: return kernel_paths<T, 32>(staged, g_smem);
    case 64: return kernel_paths<T, 64>(staged, g_smem);
    case 128: return kernel_paths<T, 128>(staged, g_smem);
    default: return nullptr;
  }
}

const void* kernel_for(int dtype, int bs, int staged, int g_smem) {
  if (dtype == DT_F32) return kernel_bs<float>(bs, staged, g_smem);
  if (dtype == DT_BF16) return kernel_bs<__nv_bfloat16>(bs, staged, g_smem);
  return nullptr;
}

}  // namespace

// Paths and grid for nbr block-rows of `ell` bs x bs blocks, n columns, on
// `device`: they follow from the shape and the card alone.
extern "C" int repro_fused_grad_bsr_plan(int device, long long nbr, int ell,
                                         int bs, int n, int dtype,
                                         int* staged, int* g_smem,
                                         int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || ell < 1 || n < bs) return cudaErrorInvalidValue;
  *staged = (size_t)ell * bs * bs * sizeof(float) <= (size_t)kTileBudget;
  *g_smem = smem_bytes(bs, ell, n, *staged, 1) <= (size_t)kGSmemBudget;
  const void* fn = kernel_for(dtype, bs, *staged, *g_smem);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bs, ell, n, *staged, *g_smem);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, occ = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long g = (long long)sms * occ;
  *grid = (int)(nbr < g ? nbr : g);
  return cudaSuccess;
}

// data (nbr, ell, bs, bs) f32 or bf16, cols (nbr, ell) int32, x (n) f32,
// t, w (nbr*bs) f32; z (nbr*bs), g_part (grid, n), f_part (grid), g (n) and
// f (1) f32 outputs and scratch.
extern "C" int repro_fused_grad_bsr(int device, const void* data, int dtype,
                                    const void* cols, const void* x,
                                    const void* t, const void* w,
                                    long long nbr, int ell, int bs, int n,
                                    int staged, int g_smem, int grid,
                                    int loss, float param, void* z,
                                    void* g_part, void* f_part, void* g,
                                    void* f, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* fn = kernel_for(dtype, bs, staged, g_smem);
  if (fn == nullptr || grid < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bs, ell, n, staged, g_smem);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long nb = nbr;
  int ee = ell, nn = n, ll = loss;
  float pp = param;
  void* args[] = {const_cast<void**>(&data), const_cast<void**>(&cols),
                  const_cast<void**>(&x), const_cast<void**>(&t),
                  const_cast<void**>(&w), &nb, &ee, &nn, &ll, &pp, &z,
                  &g_part, &f_part};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned rblocks = (unsigned)((n + kThreads - 1) / kThreads);
  fgb_reduce<<<rblocks, kThreads, 0, s>>>(
      static_cast<const float*>(g_part), static_cast<const float*>(f_part),
      grid, n, static_cast<float*>(g), static_cast<float*>(f));
  return cudaGetLastError();
}

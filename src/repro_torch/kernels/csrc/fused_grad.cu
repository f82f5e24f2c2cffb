// Fused composite gradient, one read of A:
//   f = sum_i w_i l((Ax)_i, t_i),  g = A^T (w o l'(Ax, t)),  z = Ax.
//
// Replaces the TPU kernel src/repro/kernels/fusedgrad.py:fused_grad
// (_fused_grad_kernel).  Bandwidth-bound on the H100: 4mn flops against
// m*n*sizeof(storage) bytes, far below the card's flop/byte balance.
//
// Design.  The TPU kernel walks row blocks on a sequential grid and carries
// g and f in VMEM scratch.  Here a persistent grid (blocks = SMs x
// occupancy) walks row blocks of `bm` rows with a block stride.  Each row
// block is read from HBM once:
//   * staged path (bm*n floats fit the shared-memory budget): the block is
//     copied into shared memory as f32, then z = A_blk x (one warp per row,
//     shuffle reduce), r = w o l'(z, t) and g += r A_blk all read it there;
//   * unstaged path (wide n): both sweeps read the block from global memory;
//     the second finds it in L2, since a block is only bm rows.
// Each block keeps its g (shared memory, or its own row of the partials
// buffer) and its f, and writes one (n,) partial and one f.  A second kernel
// sums the partials in block order, so repeated runs give the same bits (no
// float atomics).  Ragged m and n are masked, not padded.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBudgetSmall = 72 * 1024;   // three blocks per SM
constexpr int kBudgetLarge = 200 * 1024;  // one block per SM
constexpr int kMaxRows = 32;

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

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fused_grad_partials(const T* __restrict__ a, const float* __restrict__ x,
                    const float* __restrict__ t, const float* __restrict__ w,
                    long long m, int n, int bm, int loss, float param,
                    float* __restrict__ z, float* __restrict__ g_part,
                    float* __restrict__ f_part) {
  // Staged layout: tile[bm * n] | g[n] | r[bm].  Unstaged: r[bm], and g is
  // this block's row of the partials buffer.
  extern __shared__ float smem[];
  __shared__ float f_warp[kWarps];
  float* tile = smem;
  float* g_acc = STAGED ? smem + (size_t)bm * n
                        : g_part + (size_t)blockIdx.x * n;
  float* r_s = STAGED ? g_acc + n : smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n; j += kThreads) g_acc[j] = 0.f;
  float f_acc = 0.f;  // lane 0 of each warp: the loss of that warp's rows

  for (long long r0 = (long long)blockIdx.x * bm; r0 < m;
       r0 += (long long)gridDim.x * bm) {
    const int rows = (int)min((long long)bm, m - r0);
    const T* blk = a + r0 * n;
    if (STAGED) {
      const int count = rows * n;
      for (int e = tid; e < count; e += kThreads) tile[e] = to_f32(blk[e]);
      __syncthreads();
    }
    // z = A_blk x: one warp per row; lane 0 evaluates the loss.
    for (int i = warp; i < rows; i += kWarps) {
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float v = STAGED ? tile[i * n + j] : to_f32(blk[(size_t)i * n + j]);
        acc = fmaf(v, __ldg(x + j), acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const long long row = r0 + i;
        float le, r;
        row_loss(loss, param, acc, t[row], w[row], &le, &r);
        z[row] = acc;
        r_s[i] = r;
        f_acc += le;
      }
    }
    __syncthreads();
    // g += r A_blk: each thread owns columns tid, tid + kThreads, ...
    for (int j = tid; j < n; j += kThreads) {
      float acc = g_acc[j];
      for (int i = 0; i < rows; ++i) {
        const float v = STAGED ? tile[i * n + j] : to_f32(blk[(size_t)i * n + j]);
        acc = fmaf(r_s[i], v, acc);
      }
      g_acc[j] = acc;
    }
    __syncthreads();  // the next row block overwrites tile and r_s
  }

  if (STAGED)
    for (int j = tid; j < n; j += kThreads)
      g_part[(size_t)blockIdx.x * n + j] = g_acc[j];
  if (lane == 0) f_warp[warp] = f_acc;
  __syncthreads();
  if (tid == 0) {
    float f = 0.f;
    for (int k = 0; k < kWarps; ++k) f += f_warp[k];
    f_part[blockIdx.x] = f;
  }
}

// Second pass: sum the per-block partials in block order.
__global__ void fused_grad_reduce(const float* __restrict__ g_part,
                                  const float* __restrict__ f_part, int parts,
                                  int n, float* __restrict__ g,
                                  float* __restrict__ f) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) {
    float s = 0.f;
    for (int b = 0; b < parts; ++b) s += g_part[(size_t)b * n + j];
    g[j] = s;
  }
  if (j == 0) {
    float s = 0.f;
    for (int b = 0; b < parts; ++b) s += f_part[b];
    f[0] = s;
  }
}

const void* kernel_for(int dtype, int staged) {
  if (dtype == DT_BF16)
    return staged ? (const void*)&fused_grad_partials<__nv_bfloat16, true>
                  : (const void*)&fused_grad_partials<__nv_bfloat16, false>;
  return staged ? (const void*)&fused_grad_partials<float, true>
                : (const void*)&fused_grad_partials<float, false>;
}

size_t smem_bytes(int n, int bm, int staged) {
  return staged ? ((size_t)bm * n + n + bm) * sizeof(float)
                : (size_t)bm * sizeof(float);
}

}  // namespace

// Row-block height, path and grid for an (m x n) operand on `device`.
extern "C" int repro_fused_grad_plan(int device, long long m, int n, int dtype,
                                     int* bm, int* staged, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int rows = (kBudgetSmall / 4 - n) / (n + 1);
  if (rows < 8) rows = (kBudgetLarge / 4 - n) / (n + 1);
  *staged = rows >= 8;
  *bm = *staged ? (rows < kMaxRows ? rows : kMaxRows) : kMaxRows;
  const size_t smem = smem_bytes(n, *bm, *staged);
  const void* fn = kernel_for(dtype, *staged);
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
  long long g = (long long)sms * occ;
  if (blocks < g) g = blocks;
  *grid = g < 1 ? 1 : (int)g;
  return cudaSuccess;
}

extern "C" int repro_fused_grad(int device, const void* a, int dtype,
                                const void* x, const void* t, const void* w,
                                long long m, int n, int bm, int staged,
                                int grid, int loss, float param, void* z,
                                void* g_part, void* f_part, void* g, void* f,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(n, bm, staged);
  const void* fn = kernel_for(dtype, staged);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(t);
  const float* wf = static_cast<const float*>(w);
  float* zf = static_cast<float*>(z);
  float* gp = static_cast<float*>(g_part);
  float* fp = static_cast<float*>(f_part);
  if (dtype == DT_BF16) {
    const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(a);
    if (staged)
      fused_grad_partials<__nv_bfloat16, true><<<grid, kThreads, smem, s>>>(
          ab, xf, tf, wf, m, n, bm, loss, param, zf, gp, fp);
    else
      fused_grad_partials<__nv_bfloat16, false><<<grid, kThreads, smem, s>>>(
          ab, xf, tf, wf, m, n, bm, loss, param, zf, gp, fp);
  } else {
    const float* af = static_cast<const float*>(a);
    if (staged)
      fused_grad_partials<float, true><<<grid, kThreads, smem, s>>>(
          af, xf, tf, wf, m, n, bm, loss, param, zf, gp, fp);
    else
      fused_grad_partials<float, false><<<grid, kThreads, smem, s>>>(
          af, xf, tf, wf, m, n, bm, loss, param, zf, gp, fp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rblocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  fused_grad_reduce<<<rblocks, kThreads, 0, s>>>(gp, fp, grid, n,
                                                 static_cast<float*>(g),
                                                 static_cast<float*>(f));
  return cudaGetLastError();
}

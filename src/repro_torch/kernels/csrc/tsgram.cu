// Tall-skinny Gram matrix G = A^T A for an (m x n) row-major A.
//
// Replaces the TPU kernel src/repro/kernels/tsgram.py:tsgram
// (_tsgram_kernel).  Compute-bound on the H100: m*n*(n+1) multiply-adds for
// the distinct entries against one read of A.  This first version runs f32
// FMA on the CUDA cores (no tensor cores, no TF32).
//
// Design.  The TPU kernel streams row blocks on a sequential grid into one
// resident (n x n) accumulator.  Here the output is cut into 64 x 64 tiles
// and only the upper triangle of tiles is computed (G is symmetric).  The m
// rows are split into `slices`, so that tiles x slices fills the card; each
// block (tile, slice) stages 16-row chunks of A[:, I] and A[:, J] in shared
// memory and accumulates a 4 x 4 register tile per thread.  Each slice
// writes its own partial tile; a second kernel sums the slices in order
// (the same bits on every run, no float atomics), mirrors the lower
// triangle and casts to the output type.  Ragged m and n are masked.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
tsgram_partials(const T* __restrict__ a, long long m, int n, int tiles,
                long long rows_per_slice, float* __restrict__ part) {
  // blockIdx.x enumerates the upper-triangle tiles (ti <= tj) row by row.
  int p = blockIdx.x, ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int i0 = ti * kTile, j0 = tj * kTile;
  __shared__ float as[kChunk][kTile];  // A[r, i0 : i0 + 64]
  __shared__ float bs[kChunk][kTile];  // A[r, j0 : j0 + 64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  const long long r_begin = (long long)blockIdx.y * rows_per_slice;
  const long long r_end = min(m, r_begin + rows_per_slice);

  for (long long r = r_begin; r < r_end; r += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const long long row = r + k;
      const bool in = row < r_end;
      as[k][c] = (in && i0 + c < n) ? to_f32(a[row * n + i0 + c]) : 0.f;
      bs[k][c] = (in && j0 + c < n) ? to_f32(a[row * n + j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        av[q] = as[k][ty * 4 + q];
        bv[q] = bs[k][tx * 4 + q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[q][s] = fmaf(av[q], bv[s], acc[q][s]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.y * n * n;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = i0 + ty * 4 + q, j = j0 + tx * 4 + s;
      if (i < n && j < n) out[(size_t)i * n + j] = acc[q][s];
    }
}

// Second pass: G[i, j] = sum over slices of part[(min, max)] in slice order.
template <typename TO>
__global__ void tsgram_reduce(const float* __restrict__ part, int slices,
                              int n, TO* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * n) return;
  const int i = (int)(e / n), j = (int)(e % n);
  const size_t src = (size_t)min(i, j) * n + max(i, j);
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[(size_t)k * n * n + src];
  store_f32(out + e, s);
}

}  // namespace

extern "C" int repro_tsgram(int device, const void* a, int dtype, long long m,
                            int n, int slices, long long rows_per_slice,
                            void* part, void* out, int out_dtype,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, slices);
  float* pf = static_cast<float*>(part);
  if (dtype == DT_BF16)
    tsgram_partials<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), m, n, tiles, rows_per_slice, pf);
  else
    tsgram_partials<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), m, n, tiles, rows_per_slice, pf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * n;
  const unsigned rblocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (out_dtype == DT_BF16)
    tsgram_reduce<__nv_bfloat16><<<rblocks, kThreads, 0, s>>>(
        pf, slices, n, static_cast<__nv_bfloat16*>(out));
  else
    tsgram_reduce<float><<<rblocks, kThreads, 0, s>>>(
        pf, slices, n, static_cast<float*>(out));
  return cudaGetLastError();
}

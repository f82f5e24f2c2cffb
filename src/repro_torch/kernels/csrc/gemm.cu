// Dense product C = A @ B, A (m x K), B (K x N), all row-major.
//
// Replaces the TPU kernel src/repro/kernels/gemm.py:gemm (_gemm_kernel).
// On the main path it runs skinny, (m x n) @ (n x k) with k <= 64 (U
// recovery in the SVD, Q recovery in TSQR), where it is bandwidth-bound on
// the read of A: 2mKN flops against m*K*sizeof(storage) bytes.
//
// Design.  A classic shared-memory tiled SGEMM with register blocking: 256
// threads per block, a 4 x 4 output tile per thread, K streamed through
// shared memory in chunks of 16.  The block tile (BM x BN) follows N so that
// a narrow N does not waste a 64-wide tile: (256 x 16) for N <= 16,
// (128 x 32) for N <= 32, else (64 x 64).  Each block owns its output tile
// and loops over all of K, so there is no cross-block reduction.  bf16
// operands are upcast on load, sums are f32, and the output is cast once.
// Ragged edges are masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

template <int BM, int BN, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
            TC* __restrict__ c, long long m, int K, int N) {
  constexpr int TM = 4, TN = 4, TX = BN / TN;
  static_assert((BM / TM) * (BN / TN) == kThreads, "one 4x4 tile per thread");
  __shared__ float as[kChunk][BM + 4];  // A chunk, transposed
  __shared__ float bs[kChunk][BN];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int e = threadIdx.x; e < BM * kChunk; e += kThreads) {
      const int r = e / kChunk, kk = e % kChunk;
      const long long row = row0 + r;
      const int k = k0 + kk;
      as[kk][r] = (row < m && k < K) ? to_f32(a[row * K + k]) : 0.f;
    }
    for (int e = threadIdx.x; e < kChunk * BN; e += kThreads) {
      const int kk = e / BN, cc = e % BN;
      const int k = k0 + kk, col = col0 + cc;
      bs[kk][cc] = (k < K && col < N) ? to_f32(b[(long long)k * N + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long row = row0 + ty * TM + i;
      const int col = col0 + tx * TN + j;
      if (row < m && col < N) store_f32(c + row * N + col, acc[i][j]);
    }
}

template <int BM, int BN, typename TA, typename TB, typename TC>
void launch(const void* a, const void* b, void* c, long long m, int K, int N,
            cudaStream_t s) {
  const dim3 grid((unsigned)((m + BM - 1) / BM), (N + BN - 1) / BN);
  gemm_kernel<BM, BN, TA, TB, TC><<<grid, kThreads, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TC*>(c), m, K, N);
}

template <typename TA, typename TB, typename TC>
void launch_tiled(const void* a, const void* b, void* c, long long m, int K,
                  int N, cudaStream_t s) {
  if (N <= 16)
    launch<256, 16, TA, TB, TC>(a, b, c, m, K, N, s);
  else if (N <= 32)
    launch<128, 32, TA, TB, TC>(a, b, c, m, K, N, s);
  else
    launch<64, 64, TA, TB, TC>(a, b, c, m, K, N, s);
}

template <typename TA, typename TB>
void launch_out(int c_dtype, const void* a, const void* b, void* c,
                long long m, int K, int N, cudaStream_t s) {
  if (c_dtype == DT_BF16)
    launch_tiled<TA, TB, __nv_bfloat16>(a, b, c, m, K, N, s);
  else
    launch_tiled<TA, TB, float>(a, b, c, m, K, N, s);
}

template <typename TA>
void launch_b(int b_dtype, int c_dtype, const void* a, const void* b, void* c,
              long long m, int K, int N, cudaStream_t s) {
  if (b_dtype == DT_BF16)
    launch_out<TA, __nv_bfloat16>(c_dtype, a, b, c, m, K, N, s);
  else
    launch_out<TA, float>(c_dtype, a, b, c, m, K, N, s);
}

}  // namespace

extern "C" int repro_gemm(int device, const void* a, int a_dtype,
                          const void* b, int b_dtype, void* c, int c_dtype,
                          long long m, int K, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == DT_BF16)
    launch_b<__nv_bfloat16>(b_dtype, c_dtype, a, b, c, m, K, N, s);
  else
    launch_b<float>(b_dtype, c_dtype, a, b, c, m, K, N, s);
  return cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

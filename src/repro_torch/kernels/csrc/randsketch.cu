// Streaming cross-Gram B = A^T Q for a tall A (m x n) and a thin Q (m x r),
// both row-major: the randomized SVD's projection.
//
// Replaces the TPU kernel src/repro/kernels/randsketch.py:randsketch
// (_randsketch_kernel).  On the H100 it is bound by the bytes of A for the
// main path's r = k + p <= 32 (2mnr flops against m*n*sizeof(storage)
// bytes), close to the line in f32: at r = 26 the f32 FMA bound is 0.65 of
// the bytes bound.  This first version runs f32 FMA on the CUDA cores.
//
// Design.  The TPU kernel tiles the output over n and streams row blocks
// of A and Q on a sequential grid into a resident (bn x r) accumulator.
// Here the output is cut into 128 x 32 tiles (128 columns of A by 32
// columns of Q; r <= 32 is one tile, so A is read once) and the m rows into
// slices of at most 65,536 rows (randsketch.py:slicing), which bounds the
// length of every f32 sum and gives enough blocks to fill the card.  Each
// block (tile, slice) stages 16-row chunks of A[:, J] and
// Q[:, R] in shared memory (bf16 upcast on load) and accumulates a 4 x 4
// register tile per thread.  Each slice writes its own partial tile; a
// second kernel sums the slices in order (the same bits on every run, no
// float atomics) and casts to the output type.  Ragged m, n and r are
// masked.
#include "common.cuh"

namespace {

constexpr int kTileN = 128;   // columns of A per block
constexpr int kTileR = 32;    // columns of Q per block
constexpr int kChunk = 16;    // rows staged per step
constexpr int kThreads = 256; // 32 x 8 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
randsketch_partials(const T* __restrict__ a, const float* __restrict__ q,
                    long long m, int n, int r, long long rows_per_slice,
                    float* __restrict__ part) {
  __shared__ __align__(16) float as[kChunk][kTileN];  // A[row, j0 : j0+128]
  __shared__ __align__(16) float qs[kChunk][kTileR];  // Q[row, c0 : c0+32]
  const int j0 = blockIdx.x * kTileN, c0 = blockIdx.y * kTileR;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[4][4] = {};  // acc[p][s]: column j0 + 4 tx + p, c0 + 4 ty + s
  const long long r_begin = (long long)blockIdx.z * rows_per_slice;
  const long long r_end = min(m, r_begin + rows_per_slice);

  for (long long row0 = r_begin; row0 < r_end; row0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTileN; e += kThreads) {
      const int kk = e / kTileN, c = e % kTileN;
      const long long row = row0 + kk;
      as[kk][c] = (row < r_end && j0 + c < n) ? to_f32(a[row * n + j0 + c])
                                              : 0.f;
    }
    for (int e = threadIdx.x; e < kChunk * kTileR; e += kThreads) {
      const int kk = e / kTileR, c = e % kTileR;
      const long long row = row0 + kk;
      qs[kk][c] = (row < r_end && c0 + c < r) ? q[row * r + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][tx * 4]);
      const float4 qv = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[p][s] = fmaf(a4[p], q4[s], acc[p][s]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * n * r;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx * 4 + p, c = c0 + ty * 4 + s;
      if (j < n && c < r) out[(size_t)j * r + c] = acc[p][s];
    }
}

// Second pass: B[j, c] = sum over slices of part[slice, j, c], in order.
template <typename TO>
__global__ void randsketch_reduce(const float* __restrict__ part, int slices,
                                  long long nr, TO* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nr) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[(size_t)k * nr + e];
  store_f32(out + e, s);
}

}  // namespace

extern "C" int repro_randsketch(int device, const void* a, int dtype,
                                const void* q, long long m, int n, int r,
                                int slices, long long rows_per_slice,
                                void* part, void* out, int out_dtype,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTileN - 1) / kTileN, (r + kTileR - 1) / kTileR,
                  slices);
  const float* qf = static_cast<const float*>(q);
  float* pf = static_cast<float*>(part);
  if (dtype == DT_BF16)
    randsketch_partials<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), qf, m, n, r, rows_per_slice,
        pf);
  else
    randsketch_partials<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), qf, m, n, r, rows_per_slice, pf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nr = (long long)n * r;
  const unsigned rblocks = (unsigned)((nr + kThreads - 1) / kThreads);
  if (out_dtype == DT_BF16)
    randsketch_reduce<__nv_bfloat16><<<rblocks, kThreads, 0, s>>>(
        pf, slices, nr, static_cast<__nv_bfloat16*>(out));
  else
    randsketch_reduce<float><<<rblocks, kThreads, 0, s>>>(
        pf, slices, nr, static_cast<float*>(out));
  return cudaGetLastError();
}

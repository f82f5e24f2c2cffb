// Y = A^T X for a block-ELL A (nbr block-rows of `ell` stored bs x bs
// blocks, block-column ids in cols[nbr][ell]) and a dense row-major f32 X
// (nbr*bs x nx): the adjoint of the unfused sparse solve, Lanczos' half of
// A^T A v, and the sparse Gram.
//
// Replaces both forms of the TPU kernel src/repro/kernels/bsr.py:
// bsr_rmatmul: the fused scatter (_bsr_rmm_kernel), which adds each
// A_ij^T X_i into a VMEM-resident accumulator at block-row cols[i, s] and is
// race-free only because the TPU grid runs in order, and the partials +
// segment_sum form (_bsr_rmm_partials_kernel) of the wide regime.  Bound by
// bytes on the H100: every stored block is read once, plus X and Y.
//
// Design.  Blocks of a GPU grid run in no order and float atomics would
// change the bits from run to run, so the scatter becomes a gather over a
// column-major index of the block pattern, built once by the wrapper (a
// stable argsort of cols, kernels/bsr.py:ColumnIndex): for block column j,
// the flat slots i*ell + s that hold it, in ascending i, cut into chunks
// of at most `chunk` slots (a hot column of a skewed pattern makes a long
// list).  Pass 1: one 256-thread block per (chunk, tile of nt <= 32 output
// columns) stages the chunk's blocks in shared memory (32 KB at a time,
// each block one contiguous 16-bytes-a-thread load) and sums
// A_ij^T X_i over them in chunk order into a (bs x nt) partial; where a
// tile has fewer outputs than threads, the inner index is split over the
// spare threads and the parts summed in a fixed order.  Pass 2: each
// output element sums its column's chunk partials in chunk order.  The
// order of every sum is fixed by the pattern alone, so runs repeat bit for
// bit.  Padding slots (zero blocks at column 0) add exact zeros, as in the
// reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 8192;   // staged blocks, f32: 32 KB
constexpr int kMaxTile = 32;         // output columns a block

template <int BS>
struct Shape {
  static constexpr int kSlots =
      kStageFloats / (BS * BS) > 0 ? kStageFloats / (BS * BS) : 1;
  static constexpr int kStage = kSlots * BS * BS;
  static constexpr int kMaxOut = BS * kMaxTile / kThreads;
};

template <int BS>
size_t smem_bytes() {
  return (size_t)(Shape<BS>::kStage + kThreads) * sizeof(float);
}

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
bsr_rmm_partials(const T* __restrict__ data, const float* __restrict__ scales,
                 const int* __restrict__ order,
                 const int* __restrict__ chunk_start,
                 const int* __restrict__ chunk_len, int ell,
                 const float* __restrict__ x, int nx, int nt,
                 float* __restrict__ part_out) {
  using S = Shape<BS>;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kElems = BS * BS;
  extern __shared__ float smem[];
  float* tile = smem;               // [kSlots][BS][BS], scaled f32
  float* red = smem + S::kStage;    // [kThreads] split partials
  __shared__ long long row_s[S::kSlots];   // block-row of each staged slot
  const int tid = threadIdx.x;
  const long long chunk = blockIdx.x;
  const int col0 = blockIdx.y * nt;
  const int start = __ldg(chunk_start + chunk);
  const int len = __ldg(chunk_len + chunk);
  const int outs = BS * nt;                       // (c, j), j fastest
  const int split = outs >= kThreads ? 1 : kThreads / outs;
  const int per = outs >= kThreads ? outs / kThreads : 1;
  const int o0 = tid % outs;
  const int part = tid / outs;
  float acc[S::kMaxOut];
#pragma unroll
  for (int k = 0; k < S::kMaxOut; ++k) acc[k] = 0.f;

  for (int e0 = 0; e0 < len; e0 += S::kSlots) {
    const int sb = min(S::kSlots, len - e0);
    for (int e = tid * V; e < sb * kElems; e += kThreads * V) {
      const long long p = __ldg(order + start + e0 + e / kElems);
      float v[V];
      load_vec<T, V>(data + p * kElems + e % kElems, v);
      const float sc = scales ? __ldg(scales + p) : 1.f;
#pragma unroll
      for (int k = 0; k < V; ++k) tile[e + k] = v[k] * sc;
    }
    if (tid < sb) row_s[tid] = __ldg(order + start + e0 + tid) / ell;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S::kMaxOut; ++k) {
      const int o = o0 + k * kThreads;
      const int j = col0 + o % nt;
      if (k < per && j < nx) {
        const int c = o / nt;
        float a = acc[k];
        for (int b = 0; b < sb; ++b) {
          const float* acol = tile + b * kElems + c;
          const float* xr = x + row_s[b] * BS * nx + j;
          for (int r = part; r < BS; r += split)
            a = fmaf(acol[r * BS], __ldg(xr + (long long)r * nx), a);
        }
        acc[k] = a;
      }
    }
    __syncthreads();   // the next stage overwrites tile and row_s
  }

  if (split > 1) {
    red[tid] = acc[0];
    __syncthreads();
    if (part == 0) {
      float sum = 0.f;
      for (int p = 0; p < split; ++p) sum += red[p * outs + o0];
      acc[0] = sum;
    }
  }
  if (part != 0) return;
#pragma unroll
  for (int k = 0; k < S::kMaxOut; ++k) {
    const int o = o0 + k * kThreads;
    const int j = col0 + o % nt;
    if (k < per && j < nx)
      part_out[(chunk * BS + o / nt) * nx + j] = acc[k];
  }
}

// Pass 2: Y[jb*bs + c, j] = sum of block column jb's chunk partials, in
// chunk order (chunks col_chunks[jb] .. col_chunks[jb+1]-1; none: 0).
__global__ void bsr_rmm_reduce(const float* __restrict__ part,
                               const int* __restrict__ col_chunks, int bs,
                               int nx, long long total,
                               float* __restrict__ y) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long row = e / nx;
  const int j = (int)(e % nx);
  const long long jb = row / bs;
  const int c = (int)(row % bs);
  float s = 0.f;
  for (long long ch = col_chunks[jb]; ch < col_chunks[jb + 1]; ++ch)
    s += part[(ch * bs + c) * nx + j];
  y[e] = s;
}

int tile_cols(int nx) {
  int nt = 1;
  while (nt < nx && nt < kMaxTile) nt <<= 1;
  return nt;
}

template <typename T, int BS>
cudaError_t launch(const void* data, const void* scales, const void* order,
                   const void* chunk_start, const void* chunk_len,
                   int nchunks, int ell, const void* x, int nx, void* part,
                   cudaStream_t s) {
  const void* fn = (const void*)&bsr_rmm_partials<T, BS>;
  const size_t smem = smem_bytes<BS>();
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nt = tile_cols(nx);
  const dim3 grid((unsigned)nchunks, (unsigned)((nx + nt - 1) / nt));
  bsr_rmm_partials<T, BS><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(data), static_cast<const float*>(scales),
      static_cast<const int*>(order), static_cast<const int*>(chunk_start),
      static_cast<const int*>(chunk_len), ell, static_cast<const float*>(x),
      nx, nt, static_cast<float*>(part));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bs(int bs, const void* data, const void* scales,
                      const void* order, const void* cs, const void* cl,
                      int nchunks, int ell, const void* x, int nx, void* part,
                      cudaStream_t s) {
  switch (bs) {
    case 8:
      return launch<T, 8>(data, scales, order, cs, cl, nchunks, ell, x, nx,
                          part, s);
    case 16:
      return launch<T, 16>(data, scales, order, cs, cl, nchunks, ell, x, nx,
                           part, s);
    case 32:
      return launch<T, 32>(data, scales, order, cs, cl, nchunks, ell, x, nx,
                           part, s);
    case 64:
      return launch<T, 64>(data, scales, order, cs, cl, nchunks, ell, x, nx,
                           part, s);
    case 128:
      return launch<T, 128>(data, scales, order, cs, cl, nchunks, ell, x, nx,
                            part, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// data (nbr, ell, bs, bs) in `dtype`, scales (nbr, ell) f32 for int8 data
// (else null); the column index: order (nbr*ell) int32 flat slots sorted by
// column, chunk_start/chunk_len (nchunks) int32 into order, col_chunks
// (nbc + 1) int32, the chunks of each block column; x (nbr*bs, nx) f32
// row-major; part (nchunks, bs, nx) f32 scratch -> y (nbc*bs, nx) f32.
extern "C" int repro_bsr_rmatmul(int device, const void* data, int dtype,
                                 const void* scales, const void* order,
                                 const void* chunk_start,
                                 const void* chunk_len,
                                 const void* col_chunks, int nchunks, int ell,
                                 int bs, int nbc, const void* x, int nx,
                                 void* part, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (ell < 1 || nx < 1 || nbc < 1 || nchunks < 0)
    return cudaErrorInvalidValue;
  if ((dtype == DT_I8) != (scales != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks > 0) {
    switch (dtype) {
      case DT_F32:
        err = launch_bs<float>(bs, data, scales, order, chunk_start,
                               chunk_len, nchunks, ell, x, nx, part, s);
        break;
      case DT_BF16:
        err = launch_bs<__nv_bfloat16>(bs, data, scales, order, chunk_start,
                                       chunk_len, nchunks, ell, x, nx, part,
                                       s);
        break;
      case DT_I8:
        err = launch_bs<int8_t>(bs, data, scales, order, chunk_start,
                                chunk_len, nchunks, ell, x, nx, part, s);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  const long long total = (long long)nbc * bs * nx;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  bsr_rmm_reduce<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int*>(col_chunks),
      bs, nx, total, static_cast<float*>(y));
  return cudaGetLastError();
}

// Y = A X for a block-ELL A (nbr block-rows of `ell` stored bs x bs blocks,
// block-column ids in cols[nbr][ell]) and a dense row-major f32 X (ncols x
// nx): the U = A (V S^-1) product of the sparse SVD.
//
// Replaces the TPU kernel src/repro/kernels/bsr.py:bsr_matmul (_bsr_kernel).
// Bound by bytes on the H100 for the small nx of U recovery: every stored
// block is read once (nbr*ell*bs*bs*sizeof(storage)) for 2*nx flops an
// element, plus the gathered X rows and Y (nbr*bs*nx*4).  Storage is f32,
// bf16 or int8 with a per-block f32 scale, upcast in registers; sums in f32.
//
// Design.  The TPU kernel walks (block-row, slot) on a sequential grid into
// a (bs x nx) VMEM accumulator; the wrapper padded nx to 128 lanes.  Here
// one 256-thread block owns one block-row and a tile of nt <= 32 output
// columns (nt the next power of two >= nx, so nothing is padded and the
// ragged edge is masked).  It stages the block-row's stored blocks in
// shared memory, up to 32 KB of consecutive slots at a time (one
// contiguous stretch of memory, loaded 16 bytes a thread, so bs = 8 and 16
// load as whole sectors), then every thread runs the dot products of its
// outputs over the staged slots, reading the X rows gathered at each
// slot's column.  Where a tile has fewer outputs than threads, the inner
// index is split over the spare threads and the parts are summed in a
// fixed order; each block writes only its own rows, so there is no
// reduction across blocks and runs repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 8192;   // staged slots, f32: 32 KB
constexpr int kMaxTile = 32;         // output columns a block

template <int BS>
struct Shape {
  static constexpr int kSlots =
      kStageFloats / (BS * BS) > 0 ? kStageFloats / (BS * BS) : 1;
  static constexpr int kStage = kSlots * BS * BS;
  static constexpr int kMaxOut = BS * kMaxTile / kThreads;  // outputs a thread
};

template <int BS>
size_t smem_bytes() {
  return (size_t)(Shape<BS>::kStage + kThreads) * sizeof(float);
}

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const T* __restrict__ data, const float* __restrict__ scales,
                const int* __restrict__ cols, const float* __restrict__ x,
                int ell, int nx, int nt, float* __restrict__ y) {
  using S = Shape<BS>;
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ float smem[];
  float* tile = smem;               // [kSlots][BS][BS], scaled f32
  float* red = smem + S::kStage;    // [kThreads] split partials
  __shared__ int col_s[S::kSlots];
  const int tid = threadIdx.x;
  const long long i = blockIdx.x;
  const int col0 = blockIdx.y * nt;
  const int outs = BS * nt;                       // (r, j), j fastest
  const int split = outs >= kThreads ? 1 : kThreads / outs;
  const int per = outs >= kThreads ? outs / kThreads : 1;
  const int o0 = tid % outs;
  const int part = tid / outs;                    // 0 .. split-1
  float acc[S::kMaxOut];
#pragma unroll
  for (int k = 0; k < S::kMaxOut; ++k) acc[k] = 0.f;
  const T* blk = data + i * ell * BS * BS;

  for (int s0 = 0; s0 < ell; s0 += S::kSlots) {
    const int sb = min(S::kSlots, ell - s0);
    const T* src = blk + (long long)s0 * BS * BS;
    for (int e = tid * V; e < sb * BS * BS; e += kThreads * V) {
      float v[V];
      load_vec<T, V>(src + e, v);
      const float sc = scales ? __ldg(scales + i * ell + s0 + e / (BS * BS))
                              : 1.f;
#pragma unroll
      for (int k = 0; k < V; ++k) tile[e + k] = v[k] * sc;
    }
    if (tid < sb) col_s[tid] = __ldg(cols + i * ell + s0 + tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S::kMaxOut; ++k) {
      const int o = o0 + k * kThreads;
      const int j = col0 + o % nt;
      if (k < per && part < split && j < nx) {
        const int r = o / nt;
        float a = acc[k];
        for (int s = 0; s < sb; ++s) {
          const float* arow = tile + (s * BS + r) * BS;
          const float* xc = x + (long long)col_s[s] * BS * nx + j;
          for (int c = part; c < BS; c += split)
            a = fmaf(arow[c], __ldg(xc + (long long)c * nx), a);
        }
        acc[k] = a;
      }
    }
    __syncthreads();   // the next stage overwrites tile and col_s
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
    if (k < per && j < nx) y[(i * BS + o / nt) * nx + j] = acc[k];
  }
}

int tile_cols(int nx) {
  int nt = 1;
  while (nt < nx && nt < kMaxTile) nt <<= 1;
  return nt;
}

template <typename T, int BS>
cudaError_t launch(const void* data, const void* scales, const void* cols,
                   const void* x, long long nbr, int ell, int nx, void* y,
                   cudaStream_t s) {
  const void* fn = (const void*)&bsr_spmm_kernel<T, BS>;
  const size_t smem = smem_bytes<BS>();
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nt = tile_cols(nx);
  const dim3 grid((unsigned)nbr, (unsigned)((nx + nt - 1) / nt));
  bsr_spmm_kernel<T, BS><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(data), static_cast<const float*>(scales),
      static_cast<const int*>(cols), static_cast<const float*>(x), ell, nx,
      nt, static_cast<float*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bs(int bs, const void* data, const void* scales,
                      const void* cols, const void* x, long long nbr, int ell,
                      int nx, void* y, cudaStream_t s) {
  switch (bs) {
    case 8: return launch<T, 8>(data, scales, cols, x, nbr, ell, nx, y, s);
    case 16: return launch<T, 16>(data, scales, cols, x, nbr, ell, nx, y, s);
    case 32: return launch<T, 32>(data, scales, cols, x, nbr, ell, nx, y, s);
    case 64: return launch<T, 64>(data, scales, cols, x, nbr, ell, nx, y, s);
    case 128:
      return launch<T, 128>(data, scales, cols, x, nbr, ell, nx, y, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// data (nbr, ell, bs, bs) in `dtype`, scales (nbr, ell) f32 for int8 data
// (else null), cols (nbr, ell) int32, x (ncols, nx) f32 row-major ->
// y (nbr * bs, nx) f32.
extern "C" int repro_bsr_spmm(int device, const void* data, int dtype,
                              const void* scales, const void* cols,
                              long long nbr, int ell, int bs, const void* x,
                              int nx, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || ell < 1 || nx < 1 || nbr > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if ((dtype == DT_I8) != (scales != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_bs<float>(bs, data, scales, cols, x, nbr, ell, nx, y, s);
    case DT_BF16:
      return launch_bs<__nv_bfloat16>(bs, data, scales, cols, x, nbr, ell,
                                      nx, y, s);
    case DT_I8:
      return launch_bs<int8_t>(bs, data, scales, cols, x, nbr, ell, nx, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

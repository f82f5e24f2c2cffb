// y = A x for a block-ELL A (nbr block-rows of `ell` stored bs x bs blocks,
// block-column ids in cols[nbr][ell]) and a dense f32 vector x.
//
// Replaces the TPU kernel src/repro/kernels/bsr.py:bsr_matvec
// (_bsr_spmv_kernel).  Bound by bytes on the H100: every stored block is
// read once (nbr*ell*bs*bs*sizeof(storage)), against 2 flops an element.
// Storage is f32, bf16 or int8 with a per-block f32 scale (the TPU
// kernel's _load_block); everything is upcast in registers and summed in
// f32.
//
// Design.  The TPU kernel walks (block-row, slot) on a sequential grid and
// keeps a (1 x bs) accumulator in VMEM.  Here a block-row is one unit of
// work and nothing is reduced across blocks: a 256-thread block takes one
// block-row (bs >= 32) or several (bs = 8, 16: 1024 f32 elements a pass),
// each thread loads 16 bytes of a stored block at a time (consecutive
// threads on consecutive bytes, so a tiny block-row still loads as whole
// sectors), multiplies them with the x entries gathered at the slot's
// column and keeps one f32 sum per block row it touches.  The bs / V
// threads that share a row then sum their partials with a butterfly in a
// fixed order, so runs repeat bit for bit.  bs is a template parameter
// (8, 16, 32, 64, 128: the reference's BS_CANDIDATES).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int BS>
struct Shape {
  // Elements a thread loads at once: 16 bytes, at most one block row.
  static constexpr int V = 16 / (int)sizeof(T) < BS ? 16 / (int)sizeof(T)
                                                    : BS;
  static constexpr int kElems = BS * BS;
  static constexpr int kPerPass = kThreads * V;
  static constexpr int kTile = kPerPass > kElems ? kPerPass : kElems;
  static constexpr int kRowsPerCta = kTile / kElems;  // block-rows a block
  static constexpr int kPasses = kTile / kPerPass;    // loads a thread a slot
  static constexpr int kGroup = BS / V;               // threads on one row
};

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const T* __restrict__ data, const float* __restrict__ scales,
                const int* __restrict__ cols, const float* __restrict__ x,
                long long nbr, int ell, float* __restrict__ y) {
  using S = Shape<T, BS>;
  constexpr int V = S::V;
  const int tid = threadIdx.x;
  // With several block-rows a block there is one pass, so q is fixed.
  const int q = (tid * V) / S::kElems;
  const long long i = (long long)blockIdx.x * S::kRowsPerCta + q;
  const bool live = i < nbr;
  float acc[S::kPasses];
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p) acc[p] = 0.f;
  if (live) {
    const T* blk = data + i * ell * S::kElems;
    const int* ci = cols + i * ell;
    for (int s = 0; s < ell; ++s) {
      const long long xb = (long long)__ldg(ci + s) * BS;
      const T* b = blk + (long long)s * S::kElems;
      const float sc = scales ? __ldg(scales + i * ell + s) : 1.f;
#pragma unroll
      for (int p = 0; p < S::kPasses; ++p) {
        const int o = (tid * V + p * S::kPerPass) % S::kElems;
        const int c0 = o % BS;
        float a[V];
        load_vec<T, V>(b + o, a);
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < V; ++k)
          part = fmaf(a[k], __ldg(x + xb + c0 + k), part);
        acc[p] = fmaf(sc, part, acc[p]);
      }
    }
  }
  // The kGroup neighbouring threads on one row sum their partials.
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p)
#pragma unroll
    for (int off = S::kGroup / 2; off > 0; off >>= 1)
      acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);
  if (live && tid % S::kGroup == 0) {
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) {
      const int o = (tid * V + p * S::kPerPass) % S::kElems;
      y[i * BS + o / BS] = acc[p];
    }
  }
}

template <typename T, int BS>
cudaError_t launch(const void* data, const void* scales, const void* cols,
                   const void* x, long long nbr, int ell, void* y,
                   cudaStream_t s) {
  using S = Shape<T, BS>;
  const long long blocks = (nbr + S::kRowsPerCta - 1) / S::kRowsPerCta;
  bsr_spmv_kernel<T, BS><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const float*>(scales),
      static_cast<const int*>(cols), static_cast<const float*>(x), nbr, ell,
      static_cast<float*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bs(int bs, const void* data, const void* scales,
                      const void* cols, const void* x, long long nbr, int ell,
                      void* y, cudaStream_t s) {
  switch (bs) {
    case 8: return launch<T, 8>(data, scales, cols, x, nbr, ell, y, s);
    case 16: return launch<T, 16>(data, scales, cols, x, nbr, ell, y, s);
    case 32: return launch<T, 32>(data, scales, cols, x, nbr, ell, y, s);
    case 64: return launch<T, 64>(data, scales, cols, x, nbr, ell, y, s);
    case 128: return launch<T, 128>(data, scales, cols, x, nbr, ell, y, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// data (nbr, ell, bs, bs) in `dtype`, scales (nbr, ell) f32 for int8 data
// (else null), cols (nbr, ell) int32, x (ncols) f32 -> y (nbr * bs) f32.
extern "C" int repro_bsr_spmv(int device, const void* data, int dtype,
                              const void* scales, const void* cols,
                              long long nbr, int ell, int bs, const void* x,
                              void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || ell < 1) return cudaErrorInvalidValue;
  if ((dtype == DT_I8) != (scales != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_bs<float>(bs, data, scales, cols, x, nbr, ell, y, s);
    case DT_BF16:
      return launch_bs<__nv_bfloat16>(bs, data, scales, cols, x, nbr, ell, y,
                                      s);
    case DT_I8:
      return launch_bs<int8_t>(bs, data, scales, cols, x, nbr, ell, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared helpers for the port's hand-written Hopper kernels.
//
// Storage types are f32 or bf16 (and int8 for the block-sparse kernels,
// with a per-block f32 scale; fp8, e4m3 or e5m2, for the dense operand of
// fused_grad_multi, tsgram, gemm and randsketch); the kernels upcast what
// they load to f32 in registers and sum in f32, as the TPU kernels upcast
// their VMEM tiles.  Every e4m3 and every e5m2 value (its infinities and
// NaN too) is exact in f16, bf16, TF32 and f32.
// Products run on the CUDA cores or on the tensor cores: in TF32 parts
// that keep f32's precision (split_tf32 and mma_tf32 below: gemm,
// randsketch, tsgram, bsr_rmatmul), or in bf16 (flash_attention,
// hopper.cuh).  The C entry points take a dtype code per operand and
// return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

enum ReproDtype { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_F8 = 3,
                  DT_F8E5 = 4 };

using fp8 = __nv_fp8_e4m3;
using fp8e5 = __nv_fp8_e5m2;

// The two fp8 storage types and the interpretation their cvt takes.
template <typename T>
struct Fp8 {
  static constexpr bool kIs = false;
};
template <>
struct Fp8<fp8> {
  static constexpr bool kIs = true;
  static constexpr __nv_fp8_interpretation_t kKind = __NV_E4M3;
};
template <>
struct Fp8<fp8e5> {
  static constexpr bool kIs = true;
  static constexpr __nv_fp8_interpretation_t kKind = __NV_E5M2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
// fp8 -> f16 (exact, inf and NaN kept; one cvt.rn.f16x2.e4m3x2 or
// .e5m2x2 for two values on sm_89+) -> f32; byte 0 the low value.
template <typename T>
__device__ __forceinline__ float2 fp8x2_to_f32(unsigned short two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(two, Fp8<T>::kKind);
  return __half22float2(__half2(h));
}
__device__ __forceinline__ float to_f32(fp8 v) {
  return fp8x2_to_f32<fp8>(v.__x).x;
}
__device__ __forceinline__ float to_f32(fp8e5 v) {
  return fp8x2_to_f32<fp8e5>(v.__x).x;
}

// V consecutive elements at p, upcast to f32, in one load of V*sizeof(T)
// bytes (16, 8 or 4; p must be aligned to that).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[V]) {
  constexpr int kBytes = V * (int)sizeof(T);
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4,
                "load_vec takes 4, 8 or 16 bytes");
  using Word = typename std::conditional<
      kBytes == 16, uint4,
      typename std::conditional<kBytes == 8, uint2, unsigned>::type>::type;
  const Word u = *reinterpret_cast<const Word*>(p);
  if constexpr (Fp8<T>::kIs) {
    // Two values a conversion: byte 2k the low half, 2k + 1 the high.
    const unsigned short* e = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 f = fp8x2_to_f32<T>(e[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = to_f32(e[k]);
  }
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Compensated (Kahan) summation: s += v, with c carrying what the add lost
// (subtract it at the end: s - c).  The build never reassociates floats (no
// fast-math flags), so the compensation survives compilation.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// -- Asynchronous copies into shared memory -------------------------------
// Every thread of a block copies 16-byte pieces straight from global to
// shared memory (cp.async, no registers in between), commits them as one
// group a stage and waits until all but the newest `N` groups have landed.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// One 4-byte element (no alignment beyond its own).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}
// One 16-byte (4-byte) piece from global to shared memory: its first
// `bytes` (0 to 16, or 0 to 4) are read, the rest written as zeros;
// `bytes` = 0 reads nothing.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes)
               : "memory");
}
// cp_async_wait for a run-time count n <= N.
template <int N>
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if constexpr (N > 0) {
    if (n >= N) {
      cp_async_wait<N>();
      return;
    }
    cp_async_wait_n<N - 1>(n);
  } else {
    cp_async_wait<0>();
  }
}

// -- TF32 products on the tensor cores -------------------------------------
// x = hi + lo exactly: hi is x with its low 13 bits cleared (a TF32 value),
// lo the rest.  The mma reads a .tf32 operand's top 19 bits, so lo enters
// its products cut to TF32 (within 2^-10 of itself, 2^-20 of x), and
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (3xTF32) keeps nearly f32's precision:
// it drops a_lo*b_lo (2^-20 of the product) and lo's cut bits.  bf16 is
// exact in TF32, so a bf16 operand needs no low part.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, tf32) * b (8 x 8, tf32), f32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, column g), b1 (k t + 4); d0, d1 at (g,
// 2t + {0, 1}), d2, d3 at g + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- Sums across lanes ------------------------------------------------------
// Each of V partial values is summed over a group of JGS lanes (a power of
// two <= 32, the group's lanes consecutive) by the xor butterfly, offsets
// JGS/2 .. 1: the pairing tree of a full butterfly, so every sum has the
// same bits as there.  It scatters as it goes: while a lane holds two or
// more values, a level keeps half of them (the upper half on lanes with
// that offset's bit set) and sends the other half, so a level costs half
// the shuffles of the last.  At the end lane jg holds, in v[0..NQ), the
// sums of values jg * NQ + q when V >= JGS (NQ = V / JGS), else of value
// jg >> log2(JGS / V), which the JGS / V lanes sharing it hold alike.
template <int JGS, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int jg) {
#pragma unroll
  for (int l = 0; (JGS >> (l + 1)) >= 1; ++l) {
    const int off = JGS >> (l + 1);
    const int cnt = V >> l;   // values this lane still holds
    if (cnt >= 2) {
      const bool up = jg & off;
#pragma unroll
      for (int q = 0; q < cnt / 2; ++q) {
        const float send = up ? v[q] : v[q + cnt / 2];
        const float keep = up ? v[q + cnt / 2] : v[q];
        v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
}

// Which of reduce_scatter's V sums lane jg ends with: the first is `first`,
// there are `count` of them, and `writer` says whether this lane, of the
// lanes holding them alike, is the one to use them.
template <int JGS, int V>
struct ScatterOut {
  static constexpr int NQ = V >= JGS ? V / JGS : 1;
  int first;
  bool writer;
  __device__ __forceinline__ explicit ScatterOut(int jg) {
    if constexpr (V >= JGS) {
      first = jg * NQ;
      writer = true;
    } else {
      first = jg / (JGS / V);
      writer = jg % (JGS / V) == 0;
    }
  }
};

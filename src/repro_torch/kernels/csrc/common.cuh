// Shared helpers for the port's hand-written Hopper kernels.
//
// Storage types are f32 or bf16 (and int8 for the block-sparse kernels,
// with a per-block f32 scale); the kernels upcast what they load to f32 in
// registers and accumulate in f32 on the CUDA cores (no TF32), as the TPU
// kernels upcast their VMEM tiles, except flash_attention in bf16, which
// multiplies bf16 on the tensor cores into f32 (hopper.cuh).  The C entry
// points take a dtype code per operand and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

enum ReproDtype { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f32(e[k]);
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

// Shared helpers for the port's hand-written Hopper kernels.
//
// Storage types are f32 or bf16 (and int8 for the block-sparse kernels,
// with a per-block f32 scale); every kernel upcasts what it loads to f32 in
// registers and accumulates in f32 on the CUDA cores (no tensor cores, no
// TF32), as the TPU kernels upcast their VMEM tiles.  The C entry points
// take a dtype code per operand and return cudaGetLastError().
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

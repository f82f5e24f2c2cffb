// Shared helpers for the port's hand-written Hopper kernels.
//
// Storage types are f32 or bf16; every kernel upcasts what it loads to f32
// in registers and accumulates in f32 on the CUDA cores (no tensor cores, no
// TF32), as the TPU kernels upcast their VMEM tiles.  The C entry points
// take a dtype code per operand and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum ReproDtype { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Element access shared by the port's kernels: load a float32 or bf16
// element as f32, store an f32 value in the element type, and a ReLU that
// keeps a NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparknet {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// max(v, 0) that keeps a NaN, as jnp.maximum and torch.relu do
__device__ __forceinline__ float relu_of(float v) { return v < 0.f ? 0.f : v; }

}  // namespace sparknet

// The accumulator of the fused receive kernels (K2, K5b, K6c, K7b): float32,
// or bfloat16 for the bf16 replicas and estimates of the biggest plans.
//
// A bf16 accumulator is widened exactly to f32 on load, the kernel computes
// in f32 as it does for an f32 accumulator, and the result is rounded to
// nearest even on store: the JAX package's `acc.astype(f32)` -> kernel ->
// `.astype(acc.dtype)` (src/repro/kernels/quant.py:402,
// src/repro/distributed/wire.py:433) in one pass, 2 B of accumulator read and
// 2 B written an element where the f32 kernel moves 4 + 4.
#pragma once

#include <cuda_bf16.h>

namespace accum {

__device__ __forceinline__ float load(const float* a, size_t i) { return a[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* a, size_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store(float* o, size_t i, float v) { o[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, size_t i, float v) {
  o[i] = __float2bfloat16_rn(v);
}

}  // namespace accum

// The accumulator of the fused receive kernels (K2, K5b, K6c, K7b): float32,
// or bfloat16 for the bf16 replicas and estimates of the biggest plans.
//
// A bf16 accumulator is widened exactly to f32 on load, the kernel computes
// in f32 as it does for an f32 accumulator, and the result is rounded to
// nearest even on store: the JAX package's `acc.astype(f32)` -> kernel ->
// `.astype(acc.dtype)` (src/repro/kernels/quant.py:402,
// src/repro/distributed/wire.py:433) in one pass, 2 B of accumulator read and
// 2 B written an element where the f32 kernel moves 4 + 4.
//
// `load`/`store` move one element.  `Vec<Acc, N>` holds N consecutive
// elements (N = 4 or 8) as loaded, widened per element by `get`: one 16-byte
// access for 8 bf16 or 4 f32 (two for 8 f32), 8 bytes for 4 bf16.  The
// vector helpers need an address aligned to the vector's bytes; `vec` false
// takes N scalar accesses instead, for any alignment.
#pragma once

#include <cstdint>
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

template <typename Acc, int N>
struct Vec;

template <int N>
struct Vec<float, N> {
  static_assert(N % 4 == 0, "f32 vectors are whole float4s");
  float4 q[N / 4];
  __device__ __forceinline__ float get(int e) const {
    const float4& f = q[e / 4];
    return e % 4 == 0 ? f.x : e % 4 == 1 ? f.y : e % 4 == 2 ? f.z : f.w;
  }
};

template <int N>
struct Vec<__nv_bfloat16, N> {
  static_assert(N == 4 || N == 8, "bf16 vectors are 8 or 16 bytes");
  uint32_t u[N / 2];                     // element 2m in the low half of u[m]
  __device__ __forceinline__ float get(int e) const {
    return __uint_as_float(e % 2 == 0 ? u[e / 2] << 16 : u[e / 2] & 0xFFFF0000u);
  }
};

template <int N>
__device__ __forceinline__ Vec<float, N> load_vec(const float* a, size_t i, bool vec) {
  Vec<float, N> v;
#pragma unroll
  for (int m = 0; m < N / 4; ++m) {
    if (vec) {
      v.q[m] = reinterpret_cast<const float4*>(a + i)[m];
    } else {
      const float* s = a + i + 4 * m;
      v.q[m] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  return v;
}

template <int N>
__device__ __forceinline__ Vec<__nv_bfloat16, N> load_vec(const __nv_bfloat16* a, size_t i,
                                                          bool vec) {
  Vec<__nv_bfloat16, N> v;
  const auto* s = reinterpret_cast<const unsigned short*>(a + i);
  if (vec) {
    if constexpr (N == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(s);
      v.u[0] = x.x;
      v.u[1] = x.y;
      v.u[2] = x.z;
      v.u[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(s);
      v.u[0] = x.x;
      v.u[1] = x.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < N / 2; ++m)
      v.u[m] = static_cast<uint32_t>(s[2 * m]) | static_cast<uint32_t>(s[2 * m + 1]) << 16;
  }
  return v;
}

// o[0..N) rounded to the accumulator's type at a[i..i+N)
template <int N>
__device__ __forceinline__ void store_vec(float* a, size_t i, const float (&o)[N], bool vec) {
#pragma unroll
  for (int m = 0; m < N / 4; ++m) {
    const float4 f = make_float4(o[4 * m], o[4 * m + 1], o[4 * m + 2], o[4 * m + 3]);
    if (vec) {
      reinterpret_cast<float4*>(a + i)[m] = f;
    } else {
      float* d = a + i + 4 * m;
      d[0] = f.x;
      d[1] = f.y;
      d[2] = f.z;
      d[3] = f.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* a, size_t i, const float (&o)[N],
                                          bool vec) {
  uint32_t u[N / 2];
#pragma unroll
  for (int m = 0; m < N / 2; ++m) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * m], o[2 * m + 1]);   // .x low
    u[m] = *reinterpret_cast<const uint32_t*>(&h);
  }
  auto* d = reinterpret_cast<unsigned short*>(a + i);
  if (vec) {
    if constexpr (N == 8) {
      *reinterpret_cast<uint4*>(d) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      *reinterpret_cast<uint2*>(d) = make_uint2(u[0], u[1]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N / 2; ++m) {
      d[2 * m] = static_cast<unsigned short>(u[m] & 0xFFFFu);
      d[2 * m + 1] = static_cast<unsigned short>(u[m] >> 16);
    }
  }
}

}  // namespace accum

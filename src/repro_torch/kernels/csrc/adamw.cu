// The optim layer's AdamW update, for Hopper (sm_90a): one pass over a leaf.
//
// `adamw_update` replaces no TPU kernel: the JAX package's AdamW is jnp code
// that XLA fuses into one pass.  It replaces the port's eager AdamW body
// (kernels/ref.py `adamw_update_ref`), about 15 elementwise launches a leaf
// and some 34 passes of 4 bytes an element, with three leaf-sized
// temporaries.  Per element, in the eager body's order:
//   m   = m*b1 + R((1-b1)*g)
//   v   = v*b2 + R(R((1-b2)*g) * g)
//   upd = ((m * (1/bc1)) / (sqrt(v * (1/bc2)) + eps) + R(wd*p)) * (-lr)
// where R rounds to the dtype of g and p, one dtype (the identity for f32;
// bf16 under ECD's bf16 estimates, with m and v in f32).
//   Bound on this card: bytes.  g, p, m and v are read once and m, v and the
// update written once: 28 B an f32 element (24 with bf16 g and p), some 20
// instructions of arithmetic.  Design: a grid-stride loop over the flat leaf,
// 4 elements a thread a trip as 16-byte vectors (8 bytes for 4 bf16), enough
// 256-thread blocks to fill every SM to its occupancy, so each SM keeps some
// hundred kB of loads in flight; g and p are read with the streaming
// (evict-first) hint, since nothing reads them again in the pass and a leaf
// is many times the L2.  Nothing is staged in device memory.  A leaf whose
// pointers are off the vectors' alignment (a view into a larger buffer) runs
// the same loop one element a trip; the tail of an aligned leaf that is not
// a whole vector is done by scalars.
//
// Exactness: bit-equal to the eager body on the card.  Every product, sum,
// quotient and the square root is a _rn intrinsic, so nvcc cannot contract a
// product and a sum into an FMA (torch's elementwise kernels each round
// their one operation).  The scalars come from the host as torch hands them
// to its functors: f32 of b1, 1-b1, b2, 1-b2, eps, wd and -lr, and a division
// by a host scalar as the product with its f32 reciprocal (torch's CUDA `div`
// by a CPU scalar).  No fast-math: the division and square root are IEEE's,
// and subnormals are kept.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, neg_lr;
};

// x rounded to T and back: what an eager product in T's dtype leaves
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ float adamw_element(float g, float p, float& m, float& v,
                                               const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), round_to<T>(__fmul_rn(g, s.c1)));
  const float gg = round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(g, s.c2)), g));
  v = __fadd_rn(__fmul_rn(v, s.b2), gg);
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  const float upd = __fdiv_rn(__fmul_rn(m, s.inv_bc1), den);
  return __fmul_rn(__fadd_rn(upd, round_to<T>(__fmul_rn(p, s.wd))), s.neg_lr);
}

// 4 consecutive elements from a 16-byte (f32) or 8-byte (bf16) vector,
// read with the streaming hint
__device__ __forceinline__ void load4_stream(const float* src, int64_t i, float (&out)[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(src) + i);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load4_stream(const __nv_bfloat16* src, int64_t i,
                                             float (&out)[4]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(src) + i);
  out[0] = __uint_as_float(x.x << 16);  // bf16 -> f32 is exact: the high half
  out[1] = __uint_as_float(x.x & 0xffff0000u);
  out[2] = __uint_as_float(x.y << 16);
  out[3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ float load1_stream(const float* src, int64_t i) {
  return __ldcs(src + i);
}

__device__ __forceinline__ float load1_stream(const __nv_bfloat16* src, int64_t i) {
  const unsigned short bits = __ldcs(reinterpret_cast<const unsigned short*>(src) + i);
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

template <typename T>
__device__ __forceinline__ void adamw_scalar(const T* __restrict__ g, const T* __restrict__ p,
                                             float* __restrict__ m, float* __restrict__ v,
                                             float* __restrict__ out, int64_t i,
                                             const Scalars& s) {
  float mi = m[i], vi = v[i];
  out[i] = adamw_element<T>(load1_stream(g, i), load1_stream(p, i), mi, vi, s);
  m[i] = mi;
  v[i] = vi;
}

// kVec 4: the leaf as 16-byte vectors, then the tail; kVec 1: element by element
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const T* __restrict__ g, const T* __restrict__ p, float* __restrict__ m,
    float* __restrict__ v, float* __restrict__ out, int64_t n, Scalars s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (kVec == 4) {
    const int64_t nvec = n / 4;
    for (int64_t i = first; i < nvec; i += stride) {
      float gv[4], pv[4];
      load4_stream(g, i, gv);
      load4_stream(p, i, pv);
      float4 mv = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      float4 uv;
      uv.x = adamw_element<T>(gv[0], pv[0], mv.x, vv.x, s);
      uv.y = adamw_element<T>(gv[1], pv[1], mv.y, vv.y, s);
      uv.z = adamw_element<T>(gv[2], pv[2], mv.z, vv.z, s);
      uv.w = adamw_element<T>(gv[3], pv[3], mv.w, vv.w, s);
      reinterpret_cast<float4*>(m)[i] = mv;
      reinterpret_cast<float4*>(v)[i] = vv;
      reinterpret_cast<float4*>(out)[i] = uv;
    }
    const int64_t tail = nvec * 4 + first;
    if (tail < n) adamw_scalar<T>(g, p, m, v, out, tail, s);
  } else {
    for (int64_t i = first; i < n; i += stride) adamw_scalar<T>(g, p, m, v, out, i, s);
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T, int kVec>
cudaError_t launch(const void* g, const void* p, void* m, void* v, void* out, int64_t n,
                   const Scalars& s, cudaStream_t stream) {
  auto kernel = adamw_update_kernel<T, kVec>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t trips = (n / kVec + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(trips < full ? (trips > 0 ? trips : 1) : full);
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(p),
                                          static_cast<float*>(m), static_cast<float*>(v),
                                          static_cast<float*>(out), n, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_aligned_or_not(const void* g, const void* p, void* m, void* v, void* out,
                                  int64_t n, const Scalars& s, cudaStream_t stream) {
  const bool vec = aligned(g, 4 * sizeof(T)) && aligned(p, 4 * sizeof(T)) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(out, 16);
  return vec ? launch<T, 4>(g, p, m, v, out, n, s, stream)
             : launch<T, 1>(g, p, m, v, out, n, s, stream);
}

}  // namespace

// g, p: n elements of f32 (bf16 0) or bf16 (bf16 1); m, v: n f32, updated
// in place; out: the n f32 updates.  The scalars as the header says.
// Returns the launch's cudaError_t (0 when n is 0: nothing to launch).
extern "C" int adamw_update_launch(const void* g, const void* p, void* m, void* v, void* out,
                                   long long n, int bf16, float b1, float c1, float b2,
                                   float c2, float inv_bc1, float inv_bc2, float eps, float wd,
                                   float neg_lr, void* stream) {
  if (n <= 0) return 0;
  const Scalars s{b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, neg_lr};
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_aligned_or_not<__nv_bfloat16>(g, p, m, v, out, n, s, st)
              : launch_aligned_or_not<float>(g, p, m, v, out, n, s, st);
}

// The quant wire's kernels for Hopper (sm_90a): quantize-pack (K1) and
// unpack-dequant-axpy (K2), the send and receive of the packed
// `quant:<bits>` wire; quantize (K3), the 8-bit send; dequantize (K4a) and
// unpack-dequantize (K4b), the dense decodes of the int8 and packed payloads.
//
// K1 `quantize_pack` replaces the TPU kernel `quantize_pack_2d`
// (src/repro/kernels/quant.py, `_quant_pack_kernel` + `_stochastic_codes`).
//   Per row of a (rows, cols) f32 fold: scale = max|x|, NaN when the row
//   holds a NaN (as jnp.max and torch.amax); safe = scale > 0 ? scale : 1
//   for the divide (so a NaN row quantizes x*L unnormalised), the raw scale
//   is stored; v = x * (L / safe), u = PCG uniform of the counter
//   (offset + row*cols + lane) ^ seed, q = clip(floor v + [u < v - floor v],
//   -L, L) (`offset` places the fold in a larger one: a rank encoding one
//   node's rows of a stacked leaf hashes the whole fold's counters),
//   biased code q + L + 1 stream-packed plane-major: word w of group g sits
//   at column w*G + g and carries codes {j*G + g}.
//   Bound on this card: memory.  Each element is read once as f32 (4 B) and
//   leaves as bits/32 words (0.5 B at 4 bits) plus a 4 B scale per row, about
//   4.5 B an element at 4 bits; the f32 and integer work per element is a few
//   dozen operations, far below the 3.35 TB/s line's compute budget.
//   Design: one CTA per row.  The row is read once, coalesced, into shared
//   memory; the max-abs reduction uses warp shuffles and one shared slot per
//   warp; codes overwrite the staged row in shared memory; thread g then
//   assembles the words of group g from codes {j*G + g}, so the reads from
//   shared memory are conflict-free and the plane-major stores are coalesced.
//   Nothing but the row and its words touch device memory.
//
// K3 `quantize` replaces the TPU kernel `quantize_2d` (`_quant_kernel`): K1's
//   head (the same device functions, `stage_row_scale` and
//   `stochastic_code`), the int8 codes stored unpacked.  Bound: memory, 4 B
//   in and 1 B out an element.  Design: one CTA per row (rows on grid.x: the
//   lm_head fold has 802,816), the codes written straight from registers,
//   consecutive threads to consecutive bytes.
//
// K2 `unpack_dequant_axpy` replaces the TPU kernel `unpack_dequant_axpy_2d`
// (src/repro/kernels/quant.py, `_unpack_dequant_axpy_kernel` +
// `_unpacked_planes`).
//   out = aw*acc + code*(scale*(w*(1/L))), acc and out may be the same buffer
//   (the caller updates replicas in place; every element is read and then
//   written by the same thread).
//   Bound on this card: memory.  Per element it reads bits/8 B of words and
//   4 B of accumulator and writes 4 B, plus 4 B of scale per row: about
//   8.5 B an element at 4 bits.
//   Design: one CTA per row; thread g loads the wpg words of group g once and
//   writes out[j*G + g] for each j, so for each j a warp's loads of acc and
//   stores of out are consecutive.  The decoded neighbour never exists in
//   device memory.
//   The bf16-accumulator variant (`unpack_dequant_axpy_2d_bf16_launch`, the
//   receive into bf16 replicas) is the same template on `__nv_bfloat16`
//   (accum.cuh): 2 + 2 B of accumulator an element, about 4.5 B at 4 bits.
//
// K4b `unpack_dequant` replaces the TPU kernel `unpack_dequant_2d`
// (`_unpack_dequant_kernel`): K2's plane unpacking with no accumulator,
//   out = code*(scale*inv_l).  Bound: memory, bits/8 B in and 4 B out an
//   element.  Design: K2's, any whole number of stream groups a row.
//
// K4a `dequantize` replaces the TPU kernel `dequantize_2d` (`_dequant_kernel`):
//   out = code*(scale*inv_l) from int8 codes, any cols >= 1.  Bound: memory,
//   1 B in and 4 B out an element.  Design: a flat pass over the rows*cols
//   elements, four a thread (char4 in, float4 out) when cols % 4 == 0, one
//   otherwise; the row of an element is its index / cols.
//
// Exactness: every kernel is bit-equal to its plain PyTorch version in
// kernels/ref.py.  The hash is native uint32 arithmetic with wraparound; the
// counter is the same offset + row*cols + lane in uint32; L/safe is a correctly
// rounded division (__fdiv_rn, never fast math); every product and sum that
// the reference rounds separately is written with a _rn intrinsic, so nvcc
// cannot contract it into an FMA; 1/L is the f32 the host passes (inv_l),
// never computed here.  A NaN element's own code is implementation-defined
// in the reference (a NaN cast to an integer); here the clamp maps it to -L
// before the cast, since a NaN cast to an integer is undefined in CUDA.

#include <cstdint>
#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }

template <int BITS>
struct Geometry {
  static constexpr int kLcm = BITS * 32 / gcd_c(BITS, 32);
  static constexpr int kCpg = kLcm / BITS;   // codes per group
  static constexpr int kWpg = kLcm / 32;     // words per group
  static constexpr int kLevels = (1 << (BITS - 1)) - 1;
};

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

// max that propagates a NaN from either side (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// The head of K1 and K3, run by every thread of the CTA: stage the row in
// shared memory and return its max-abs scale (NaN when the row holds a NaN).
__device__ __forceinline__ float stage_row_scale(const float* __restrict__ xr, float* staged,
                                                 int cols, float* warp_max) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    const float v = xr[i];
    staged[i] = v;
    m = nan_max(m, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = nan_max(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (threadIdx.x == 0) warp_max[0] = t;
  }
  __syncthreads();
  return warp_max[0];
}

// L / safe, safe = scale > 0 ? scale : 1 (a NaN scale fails the compare).
__device__ __forceinline__ float code_multiplier(float s, int levels) {
  return __fdiv_rn(static_cast<float>(levels), s > 0.0f ? s : 1.0f);
}

// The stochastic code in [-L, L] of one element with counter `counter`.
__device__ __forceinline__ int stochastic_code(float x, float mul, uint32_t counter,
                                               uint32_t seed, int levels) {
  const float v = __fmul_rn(x, mul);
  const uint32_t h = pcg_hash(counter ^ seed);
  const float u = __fmul_rn(static_cast<float>(h >> 8u), 5.9604644775390625e-08f);
  const float fl = floorf(v);
  float q = __fadd_rn(fl, u < __fsub_rn(v, fl) ? 1.0f : 0.0f);
  // clamp before the cast: fmaxf maps a NaN to -L
  q = fminf(fmaxf(q, static_cast<float>(-levels)), static_cast<float>(levels));
  return static_cast<int>(q);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                     float* __restrict__ scale, int cols, uint32_t seed, uint32_t offset) {
  using Geo = Geometry<BITS>;
  constexpr int L = Geo::kLevels;
  extern __shared__ float staged[];           // the row, then its codes
  __shared__ float warp_max[kThreads / 32];

  const uint32_t row = blockIdx.x;
  const float s = stage_row_scale(x + static_cast<size_t>(row) * cols, staged, cols,
                                  warp_max);
  const float mul = code_multiplier(s, L);

  uint32_t* codes = reinterpret_cast<uint32_t*>(staged);
  const uint32_t base = offset + row * static_cast<uint32_t>(cols);
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    const int q = stochastic_code(staged[i], mul, base + static_cast<uint32_t>(i), seed, L);
    codes[i] = static_cast<uint32_t>(q + L + 1);
  }
  __syncthreads();

  const int G = cols / Geo::kCpg;
  uint32_t* wr = words + static_cast<size_t>(row) * (G * Geo::kWpg);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    uint32_t w[Geo::kWpg];
#pragma unroll
    for (int k = 0; k < Geo::kWpg; ++k) w[k] = 0u;
#pragma unroll
    for (int j = 0; j < Geo::kCpg; ++j) {
      const int bit = j * BITS, wi = bit >> 5, off = bit & 31;
      const uint32_t c = codes[j * G + g];
      w[wi] |= c << off;
      if (off + BITS > 32) w[wi + 1] |= c >> (32 - off);
    }
#pragma unroll
    for (int k = 0; k < Geo::kWpg; ++k) wr[k * G + g] = w[k];
  }
  if (threadIdx.x == 0) scale[row] = s;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                float* __restrict__ scale, int cols, int levels, uint32_t seed,
                uint32_t offset) {
  extern __shared__ float staged[];
  __shared__ float warp_max[kThreads / 32];
  const uint32_t row = blockIdx.x;
  const float s = stage_row_scale(x + static_cast<size_t>(row) * cols, staged, cols,
                                  warp_max);
  const float mul = code_multiplier(s, levels);
  int8_t* cr = codes + static_cast<size_t>(row) * cols;
  const uint32_t base = offset + row * static_cast<uint32_t>(cols);
  for (int i = threadIdx.x; i < cols; i += kThreads)
    cr[i] = static_cast<int8_t>(
        stochastic_code(staged[i], mul, base + static_cast<uint32_t>(i), seed, levels));
  if (threadIdx.x == 0) scale[row] = s;
}

// The signed code j of a group whose wpg words are `w` (K2's and K4b's
// plane unpacking, `_unpacked_planes`).
template <int BITS>
__device__ __forceinline__ int plane_code(const uint32_t* w, int j) {
  const int bit = j * BITS, wi = bit >> 5, off = bit & 31;
  uint32_t v = w[wi] >> off;
  if (off + BITS > 32) v |= w[wi + 1] << (32 - off);
  return static_cast<int>(v & ((1u << BITS) - 1u)) - (Geometry<BITS>::kLevels + 1);
}

template <int BITS, typename Acc>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_axpy_kernel(const uint32_t* __restrict__ words,
                           const float* __restrict__ scale, const Acc* acc,
                           Acc* out, int cols, float aw, float wl) {
  using Geo = Geometry<BITS>;
  const size_t row = blockIdx.x;
  const int G = cols / Geo::kCpg;
  const uint32_t* wr = words + row * (G * Geo::kWpg);
  const Acc* ar = acc + row * cols;
  Acc* orow = out + row * cols;
  const float inv = __fmul_rn(scale[row], wl);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    uint32_t w[Geo::kWpg];
#pragma unroll
    for (int k = 0; k < Geo::kWpg; ++k) w[k] = wr[k * G + g];
#pragma unroll
    for (int j = 0; j < Geo::kCpg; ++j) {
      const int i = j * G + g;
      accum::store(orow, i, __fadd_rn(__fmul_rn(aw, accum::load(ar, i)),
                                      __fmul_rn(static_cast<float>(plane_code<BITS>(w, j)),
                                                inv)));
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_kernel(const uint32_t* __restrict__ words, const float* __restrict__ scale,
                      float* __restrict__ out, int cols, float inv_l) {
  using Geo = Geometry<BITS>;
  const size_t row = blockIdx.x;
  const int G = cols / Geo::kCpg;
  const uint32_t* wr = words + row * (G * Geo::kWpg);
  float* orow = out + row * cols;
  const float inv = __fmul_rn(scale[row], inv_l);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    uint32_t w[Geo::kWpg];
#pragma unroll
    for (int k = 0; k < Geo::kWpg; ++k) w[k] = wr[k * G + g];
#pragma unroll
    for (int j = 0; j < Geo::kCpg; ++j)
      orow[j * G + g] = __fmul_rn(static_cast<float>(plane_code<BITS>(w, j)), inv);
  }
}

// VEC consecutive elements a thread per pass; they share a row when
// cols % VEC == 0.  Index is uint32_t when rows*cols fits, else size_t.
template <int VEC, typename Index>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                  float* __restrict__ out, Index n, Index cols, float inv_l) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads * VEC;
  for (Index i = (static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x) * VEC; i < n;
       i += stride) {
    const float inv = __fmul_rn(scale[i / cols], inv_l);
    if constexpr (VEC == 4) {
      const char4 c = *reinterpret_cast<const char4*>(codes + i);
      float4 o;
      o.x = __fmul_rn(static_cast<float>(c.x), inv);
      o.y = __fmul_rn(static_cast<float>(c.y), inv);
      o.z = __fmul_rn(static_cast<float>(c.z), inv);
      o.w = __fmul_rn(static_cast<float>(c.w), inv);
      *reinterpret_cast<float4*>(out + i) = o;
    } else {
      out[i] = __fmul_rn(static_cast<float>(codes[i]), inv);
    }
  }
}

template <int BITS>
void launch_quantize_pack(const float* x, uint32_t* words, float* scale, int rows,
                          int cols, uint32_t seed, uint32_t offset, cudaStream_t stream) {
  quantize_pack_kernel<BITS><<<rows, kThreads, cols * sizeof(float), stream>>>(
      x, words, scale, cols, seed, offset);
}

// threads a row for K2 and K4b: one a stream group, whole warps, <= kThreads
template <int BITS>
int group_threads(int cols) {
  const int groups = cols / Geometry<BITS>::kCpg;
  const int threads = (groups + 31) / 32 * 32;
  return threads > kThreads ? kThreads : threads;
}

template <int BITS, typename Acc>
void launch_unpack_axpy(const uint32_t* words, const float* scale, const void* acc,
                        void* out, int rows, int cols, float aw, float wl,
                        cudaStream_t stream) {
  unpack_dequant_axpy_kernel<BITS, Acc><<<rows, group_threads<BITS>(cols), 0, stream>>>(
      words, scale, static_cast<const Acc*>(acc), static_cast<Acc*>(out), cols, aw, wl);
}

template <typename Acc>
int unpack_axpy_bits(const void* words, const void* scale, const void* acc, void* out,
                     int rows, int cols, int bits, float aw, float wl, void* stream) {
  if (rows == 0) return 0;
  const uint32_t* wp = static_cast<const uint32_t*>(words);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_unpack_axpy<2, Acc>(wp, sp, acc, out, rows, cols, aw, wl, st); break;
    case 3: launch_unpack_axpy<3, Acc>(wp, sp, acc, out, rows, cols, aw, wl, st); break;
    case 4: launch_unpack_axpy<4, Acc>(wp, sp, acc, out, rows, cols, aw, wl, st); break;
    case 5: launch_unpack_axpy<5, Acc>(wp, sp, acc, out, rows, cols, aw, wl, st); break;
    case 6: launch_unpack_axpy<6, Acc>(wp, sp, acc, out, rows, cols, aw, wl, st); break;
    case 7: launch_unpack_axpy<7, Acc>(wp, sp, acc, out, rows, cols, aw, wl, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
void launch_unpack(const uint32_t* words, const float* scale, float* out, int rows, int cols,
                   float inv_l, cudaStream_t stream) {
  unpack_dequant_kernel<BITS><<<rows, group_threads<BITS>(cols), 0, stream>>>(
      words, scale, out, cols, inv_l);
}

template <int VEC, typename Index>
void launch_dequantize(const int8_t* codes, const float* scale, float* out, size_t n,
                       int cols, float inv_l, cudaStream_t stream) {
  const size_t per_cta = static_cast<size_t>(kThreads) * VEC;
  size_t grid = (n + per_cta - 1) / per_cta;
  if (grid > (1u << 20)) grid = 1u << 20;     // the grid-stride loop takes the rest
  dequantize_kernel<VEC, Index><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      codes, scale, out, static_cast<Index>(n), static_cast<Index>(cols), inv_l);
}

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrappers: contiguous row-major
// buffers on one device; K1, K3: cols % 128 == 0, cols <= 8192; K1, K2, K4b:
// bits in 2..7; K2, K4b: cols a whole number of stream groups (K2 also
// cols % 128 == 0); K3, K4a: bits in 2..8 (levels = 2^(bits-1) - 1).
extern "C" int quantize_pack_2d_launch(const void* x, void* words, void* scale,
                                       int rows, int cols, int bits,
                                       unsigned int seed, unsigned int offset,
                                       void* stream) {
  if (rows == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  uint32_t* wp = static_cast<uint32_t*>(words);
  float* sp = static_cast<float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_quantize_pack<2>(xp, wp, sp, rows, cols, seed, offset, st); break;
    case 3: launch_quantize_pack<3>(xp, wp, sp, rows, cols, seed, offset, st); break;
    case 4: launch_quantize_pack<4>(xp, wp, sp, rows, cols, seed, offset, st); break;
    case 5: launch_quantize_pack<5>(xp, wp, sp, rows, cols, seed, offset, st); break;
    case 6: launch_quantize_pack<6>(xp, wp, sp, rows, cols, seed, offset, st); break;
    case 7: launch_quantize_pack<7>(xp, wp, sp, rows, cols, seed, offset, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_dequant_axpy_2d_launch(const void* words, const void* scale,
                                             const void* acc, void* out, int rows,
                                             int cols, int bits, float aw, float wl,
                                             void* stream) {
  return unpack_axpy_bits<float>(words, scale, acc, out, rows, cols, bits, aw, wl, stream);
}

// K2 with a bfloat16 accumulator (accum.cuh): the same arithmetic in f32
extern "C" int unpack_dequant_axpy_2d_bf16_launch(const void* words, const void* scale,
                                                  const void* acc, void* out, int rows,
                                                  int cols, int bits, float aw, float wl,
                                                  void* stream) {
  return unpack_axpy_bits<__nv_bfloat16>(words, scale, acc, out, rows, cols, bits, aw, wl,
                                         stream);
}

extern "C" int quantize_2d_launch(const void* x, void* codes, void* scale, int rows,
                                  int cols, int levels, unsigned int seed,
                                  unsigned int offset, void* stream) {
  if (rows == 0) return 0;
  quantize_kernel<<<rows, kThreads, cols * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(codes), static_cast<float*>(scale),
      cols, levels, seed, offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_2d_launch(const void* codes, const void* scale, void* out,
                                    long long rows, int cols, float inv_l, void* stream) {
  const size_t n = static_cast<size_t>(rows) * cols;
  if (n == 0) return 0;
  const int8_t* cp = static_cast<const int8_t*>(codes);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool narrow = n + static_cast<size_t>(kThreads) * 4 * (1u << 20) <= 0xFFFFFFFFull;
  if (vec && narrow) launch_dequantize<4, uint32_t>(cp, sp, op, n, cols, inv_l, st);
  else if (vec) launch_dequantize<4, size_t>(cp, sp, op, n, cols, inv_l, st);
  else if (narrow) launch_dequantize<1, uint32_t>(cp, sp, op, n, cols, inv_l, st);
  else launch_dequantize<1, size_t>(cp, sp, op, n, cols, inv_l, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_dequant_2d_launch(const void* words, const void* scale, void* out,
                                        int rows, int cols, int bits, float inv_l,
                                        void* stream) {
  if (rows == 0) return 0;
  const uint32_t* wp = static_cast<const uint32_t*>(words);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_unpack<2>(wp, sp, op, rows, cols, inv_l, st); break;
    case 3: launch_unpack<3>(wp, sp, op, rows, cols, inv_l, st); break;
    case 4: launch_unpack<4>(wp, sp, op, rows, cols, inv_l, st); break;
    case 5: launch_unpack<5>(wp, sp, op, rows, cols, inv_l, st); break;
    case 6: launch_unpack<6>(wp, sp, op, rows, cols, inv_l, st); break;
    case 7: launch_unpack<7>(wp, sp, op, rows, cols, inv_l, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

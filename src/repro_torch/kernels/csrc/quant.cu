// Quantize-pack (K1) and unpack-dequant-axpy (K2): the send and receive
// kernels of the packed `quant:<bits>` gossip wire, for Hopper (sm_90a).
//
// K1 `quantize_pack` replaces the TPU kernel `quantize_pack_2d`
// (src/repro/kernels/quant.py, `_quant_pack_kernel` + `_stochastic_codes`).
//   Per row of a (rows, cols) f32 fold: scale = max|x| (0 -> 1 for the
//   divide, the raw max is stored), v = x * (L / scale), u = PCG uniform of
//   the counter (row*cols + lane) ^ seed, q = clip(floor v + [u < v - floor v],
//   -L, L), biased code q + L + 1 stream-packed plane-major: word w of group g
//   sits at column w*G + g and carries codes {j*G + g}.
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
//
// Exactness: both kernels are bit-equal to the plain PyTorch versions in
// kernels/ref.py.  The hash is native uint32 arithmetic with wraparound; the
// counter is the same row*cols + lane in uint32; L/scale is a correctly
// rounded division (__fdiv_rn, never fast math); every product and sum that
// the reference rounds separately is written with a _rn intrinsic, so nvcc
// cannot contract it into an FMA.  The one documented divergence: a NaN in a
// row gives the reference a NaN scale, while fmaxf skips it here.

#include <cstdint>
#include <cuda_runtime.h>

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

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                     float* __restrict__ scale, int cols, uint32_t seed) {
  using Geo = Geometry<BITS>;
  constexpr int L = Geo::kLevels;
  extern __shared__ float staged[];           // the row, then its codes
  __shared__ float warp_max[kThreads / 32];

  const uint32_t row = blockIdx.x;
  const float* xr = x + static_cast<size_t>(row) * cols;

  float m = 0.0f;
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    const float v = xr[i];
    staged[i] = v;
    m = fmaxf(m, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (threadIdx.x == 0) warp_max[0] = t;
  }
  __syncthreads();
  const float s = warp_max[0];
  const float safe = s > 0.0f ? s : 1.0f;
  const float mul = __fdiv_rn(static_cast<float>(L), safe);

  uint32_t* codes = reinterpret_cast<uint32_t*>(staged);
  const uint32_t base = row * static_cast<uint32_t>(cols);
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    const float v = __fmul_rn(staged[i], mul);
    const uint32_t h = pcg_hash((base + static_cast<uint32_t>(i)) ^ seed);
    const float u = __fmul_rn(static_cast<float>(h >> 8u), 5.9604644775390625e-08f);
    const float fl = floorf(v);
    float q = __fadd_rn(fl, u < __fsub_rn(v, fl) ? 1.0f : 0.0f);
    q = fminf(fmaxf(q, static_cast<float>(-L)), static_cast<float>(L));
    codes[i] = static_cast<uint32_t>(static_cast<int>(q) + L + 1);
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

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_axpy_kernel(const uint32_t* __restrict__ words,
                           const float* __restrict__ scale, const float* acc,
                           float* out, int cols, float aw, float wl) {
  using Geo = Geometry<BITS>;
  constexpr int L = Geo::kLevels;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const size_t row = blockIdx.x;
  const int G = cols / Geo::kCpg;
  const uint32_t* wr = words + row * (G * Geo::kWpg);
  const float* ar = acc + row * cols;
  float* orow = out + row * cols;
  const float inv = __fmul_rn(scale[row], wl);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    uint32_t w[Geo::kWpg];
#pragma unroll
    for (int k = 0; k < Geo::kWpg; ++k) w[k] = wr[k * G + g];
#pragma unroll
    for (int j = 0; j < Geo::kCpg; ++j) {
      const int bit = j * BITS, wi = bit >> 5, off = bit & 31;
      uint32_t v = w[wi] >> off;
      if (off + BITS > 32) v |= w[wi + 1] << (32 - off);
      const int code = static_cast<int>(v & kMask) - (L + 1);
      const int i = j * G + g;
      orow[i] = __fadd_rn(__fmul_rn(aw, ar[i]), __fmul_rn(static_cast<float>(code), inv));
    }
  }
}

template <int BITS>
void launch_quantize_pack(const float* x, uint32_t* words, float* scale, int rows,
                          int cols, uint32_t seed, cudaStream_t stream) {
  quantize_pack_kernel<BITS><<<rows, kThreads, cols * sizeof(float), stream>>>(
      x, words, scale, cols, seed);
}

template <int BITS>
void launch_unpack_axpy(const uint32_t* words, const float* scale, const float* acc,
                        float* out, int rows, int cols, float aw, float wl,
                        cudaStream_t stream) {
  const int groups = cols / Geometry<BITS>::kCpg;
  int threads = (groups + 31) / 32 * 32;
  threads = threads > kThreads ? kThreads : threads;
  unpack_dequant_axpy_kernel<BITS><<<rows, threads, 0, stream>>>(
      words, scale, acc, out, cols, aw, wl);
}

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrappers: cols % 128 == 0,
// cols <= 8192, bits in 2..7, contiguous row-major buffers on one device.
extern "C" int quantize_pack_2d_launch(const void* x, void* words, void* scale,
                                       int rows, int cols, int bits,
                                       unsigned int seed, void* stream) {
  if (rows == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  uint32_t* wp = static_cast<uint32_t*>(words);
  float* sp = static_cast<float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_quantize_pack<2>(xp, wp, sp, rows, cols, seed, st); break;
    case 3: launch_quantize_pack<3>(xp, wp, sp, rows, cols, seed, st); break;
    case 4: launch_quantize_pack<4>(xp, wp, sp, rows, cols, seed, st); break;
    case 5: launch_quantize_pack<5>(xp, wp, sp, rows, cols, seed, st); break;
    case 6: launch_quantize_pack<6>(xp, wp, sp, rows, cols, seed, st); break;
    case 7: launch_quantize_pack<7>(xp, wp, sp, rows, cols, seed, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_dequant_axpy_2d_launch(const void* words, const void* scale,
                                             const void* acc, void* out, int rows,
                                             int cols, int bits, float aw, float wl,
                                             void* stream) {
  if (rows == 0) return 0;
  const uint32_t* wp = static_cast<const uint32_t*>(words);
  const float* sp = static_cast<const float*>(scale);
  const float* ap = static_cast<const float*>(acc);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_unpack_axpy<2>(wp, sp, ap, op, rows, cols, aw, wl, st); break;
    case 3: launch_unpack_axpy<3>(wp, sp, ap, op, rows, cols, aw, wl, st); break;
    case 4: launch_unpack_axpy<4>(wp, sp, ap, op, rows, cols, aw, wl, st); break;
    case 5: launch_unpack_axpy<5>(wp, sp, ap, op, rows, cols, aw, wl, st); break;
    case 6: launch_unpack_axpy<6>(wp, sp, ap, op, rows, cols, aw, wl, st); break;
    case 7: launch_unpack_axpy<7>(wp, sp, ap, op, rows, cols, aw, wl, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

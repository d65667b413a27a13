// Sign-pack (K5a) and unpack-sign-axpy (K5b): the send and receive kernels
// of the 1-bit `sign` gossip wire, for Hopper (sm_90a).
//
// K5a `sign_pack` replaces the TPU kernel `sign_pack_2d`
// (src/repro/kernels/quant.py, `_sign_pack_kernel` + `_sign_scale`).
//   Per row of a (rows, cols) f32 fold, with G = cols/32: bit j of word g is
//   [x[j*G + g] >= 0] (so -0.0 codes +1 and NaN codes 0), and one scale per
//   row, mean|x| or sqrt(mean x^2).
//   Bound on this card: memory.  Each element is read once as f32 (4 B) and
//   leaves as one bit, plus a 4 B scale per row: about 4.13 B an element at
//   cols 1024.  The work is two or three operations an element.
//   Design: G threads per row (rows packed into a 256-thread CTA in
//   power-of-two segments).  Thread g owns word g: for each j a row's
//   threads load consecutive addresses, and the word is built in a register
//   and stored once.  The scale is a sum, so its order is fixed here and in
//   the plain version (kernels/ref.py `sign_scale_2d`): thread g adds its 32
//   elements in j order, then a halving tree over the segment's partials
//   (zero past G) in shared memory.  The division by cols is __fdiv_rn and
//   the square root __fsqrt_rn, both correctly rounded.
//
// K5b `unpack_sign_axpy` replaces the TPU kernel `unpack_sign_axpy_2d`
// (src/repro/kernels/quant.py, `_unpack_sign_axpy_kernel`).
//   out = aw*acc + (bit ? ws : -ws) with ws = scale*w; acc and out may be
//   the same buffer (each element is read and then written by one thread).
//   Bound on this card: memory.  Per element 4 B of accumulator in, 4 B
//   out, 1/8 B of words; 4 B of scale per row.
//   Design: one thread per word; thread (row, g) loads word g and the
//   row's scale once and writes out[j*G + g] for each j, so for each j the
//   loads of acc and stores of out of consecutive threads are consecutive.
//   The bf16-accumulator variant (`unpack_sign_axpy_2d_bf16_launch`, the
//   receive into bf16 estimates) is the same template on `__nv_bfloat16`
//   (accum.cuh): 2 + 2 B of accumulator an element.
//
// Exactness: both kernels are bit-equal to the plain PyTorch versions in
// kernels/ref.py.  Every product and sum the reference rounds separately is
// written with a _rn intrinsic, so nvcc cannot contract it into an FMA.

#include <cstdint>
#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                 float* __restrict__ scale, int rows, int cols, int seg, int l2) {
  __shared__ float part[kThreads];
  const int G = cols / 32;
  const int t = threadIdx.x % seg;
  const int row = blockIdx.x * (kThreads / seg) + threadIdx.x / seg;
  float s = 0.0f;
  if (row < rows && t < G) {
    const float* xr = x + static_cast<size_t>(row) * cols;
    uint32_t w = 0u;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float v = xr[j * G + t];
      w |= static_cast<uint32_t>(v >= 0.0f) << j;
      const float a = l2 ? __fmul_rn(v, v) : fabsf(v);
      s = j == 0 ? a : __fadd_rn(s, a);
    }
    words[static_cast<size_t>(row) * G + t] = w;
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = seg / 2; h > 0; h >>= 1) {
    if (t < h) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + h]);
    __syncthreads();
  }
  if (t == 0 && row < rows) {
    const float mean = __fdiv_rn(part[threadIdx.x], static_cast<float>(cols));
    scale[row] = l2 ? __fsqrt_rn(mean) : mean;
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
unpack_sign_axpy_kernel(const uint32_t* __restrict__ words,
                        const float* __restrict__ scale, const Acc* acc, Acc* out,
                        int rows, int cols, float aw, float w) {
  const int G = cols / 32;
  const size_t gid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= static_cast<size_t>(rows) * G) return;
  const size_t row = gid / G;
  const int g = static_cast<int>(gid % G);
  const uint32_t word = words[gid];
  const float ws = __fmul_rn(scale[row], w);
  const Acc* ar = acc + row * cols;
  Acc* orow = out + row * cols;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int i = j * G + g;
    const float s = (word >> j) & 1u ? ws : -ws;
    accum::store(orow, i, __fadd_rn(__fmul_rn(aw, accum::load(ar, i)), s));
  }
}

template <typename Acc>
int launch_unpack_sign_axpy(const void* words, const void* scale, const void* acc, void* out,
                            int rows, int cols, float aw, float w, void* stream) {
  if (rows == 0) return 0;
  if (cols % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t threads = static_cast<size_t>(rows) * (cols / 32);
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  unpack_sign_axpy_kernel<Acc><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scale),
      static_cast<const Acc*>(acc), static_cast<Acc*>(out), rows, cols, aw, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrappers: cols % 128 == 0,
// cols <= 8192, contiguous row-major buffers on one device.
extern "C" int sign_pack_2d_launch(const void* x, void* words, void* scale, int rows,
                                   int cols, int l2, void* stream) {
  if (rows == 0) return 0;
  if (cols % 32 != 0 || cols / 32 > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  int seg = 1;
  while (seg < cols / 32) seg <<= 1;           // power-of-two segment per row
  const int rows_per_cta = kThreads / seg;
  const int grid = (rows + rows_per_cta - 1) / rows_per_cta;
  sign_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(words),
      static_cast<float*>(scale), rows, cols, seg, l2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_sign_axpy_2d_launch(const void* words, const void* scale,
                                          const void* acc, void* out, int rows, int cols,
                                          float aw, float w, void* stream) {
  return launch_unpack_sign_axpy<float>(words, scale, acc, out, rows, cols, aw, w, stream);
}

// K5b with a bfloat16 accumulator (accum.cuh): the same arithmetic in f32
extern "C" int unpack_sign_axpy_2d_bf16_launch(const void* words, const void* scale,
                                               const void* acc, void* out, int rows, int cols,
                                               float aw, float w, void* stream) {
  return launch_unpack_sign_axpy<__nv_bfloat16>(words, scale, acc, out, rows, cols, aw, w,
                                                stream);
}

// Sparse select-pack (K6), sparse scatter-axpy (K6c) and sparse
// unpack-scatter (K6b): the send, the fused receive and the dense decode of
// the fixed-capacity `sparse` gossip wire, for Hopper (sm_90a).
//
// K6 `sparse_select_pack` replaces the TPU kernel `sparse_select_pack_2d`
// (src/repro/kernels/quant.py, `_sparse_select_pack_kernel`).
//   Per row of a (rows, cols) f32 fold: keep k = ceil(p*cols) elements in the
//   canonical order, descending key with ties to the smaller index.  randk:
//   key = pcg_hash((row*cols + lane) ^ seed) over the whole fold, as in K1,
//   and the kept values times the f32 constant cols/k; topk: key =
//   bits(|x|) + 1, and 0 for NaN, so NaN ranks below every real magnitude and
//   -0.0 ties +0.0.  Values leave as f32 or f16 (round to nearest even); the
//   indices are stream-packed at idx_bits = ceil(log2 cols) bits into kpad
//   slots: entry i goes to group i % Gi at stream position i / Gi, the tail
//   past k is zero, word w of group g sits at column w*Gi + g.
//   Bound on this card: memory.  The row is read once (4 B an element) and
//   leaves as k values and kpad*idx_bits/32 words: at cols 128 and p 0.05,
//   512 B in and 56 B out a row.  The selection is k passes over the row's
//   keys, k*cols comparisons a row (896 at cols 128, k 7), well below the
//   bytes line at these shapes.
//   Design: one warp per row, several rows per CTA.  The row's keys are
//   computed once into shared memory.  Round r takes the warp maximum of the
//   48-bit value (key << 16 | 0xFFFF - lane) over the lanes that come after
//   round r-1's winner in that order, so no lane needs a "taken" flag and a
//   key of 0 is an ordinary key (a lane's value is never 0, which is the
//   empty value).  The winners go to shared memory; then the warp gathers
//   the k values and writes the packed words, each word built in a register
//   from the entries that overlap it.
//
// K6c `sparse_scatter_axpy` replaces the TPU kernel `sparse_scatter_axpy_2d`
// (src/repro/kernels/quant.py, `_sparse_scatter_axpy_kernel` +
// `_sparse_idx_entries`).
//   out = aw*acc + (hit ? w*value : +0.0) per lane; acc and out may be the
//   same buffer (each element is read and then written by one thread).
//   Bound on this card: memory.  Per element 4 B of accumulator in and 4 B
//   out; per row k values and the index words.
//   Design: one warp per row.  The warp unpacks the k indices into a
//   lane -> slot map in shared memory (an index past cols is dropped, as the
//   TPU kernel's compare drops it), then one coalesced pass over the row
//   writes every lane.
//
// K6b `sparse_unpack_scatter` replaces the TPU kernel `sparse_unpack_scatter_2d`
// (src/repro/kernels/quant.py, `_sparse_scatter_kernel`).
//   out = hit ? 0.0f + value : +0.0 per lane: the TPU kernel adds each value
//   into zeros, so a kept -0.0 decodes to +0.0 (a kernel that stored the
//   value would keep -0.0).  Values f32 or f16.
//   Bound on this card: memory.  Per row k values and the index words in,
//   4 B an element out.
//   Design: K6c's, without the accumulator: one warp per row builds the
//   lane -> slot map in shared memory from the unpacked indices
//   (`build_slot_map`, shared with K6c), then one coalesced pass writes the
//   row.
//
// Exactness: the kernels are bit-equal to the plain PyTorch versions in
// kernels/ref.py; every product and sum is a _rn intrinsic.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxCols = 8192;              // lane and slot numbers fit 16 bits;
                                            // one row's keys and slots fit 48 KiB
constexpr int kRowLanes = 2048;             // shared-memory lanes per CTA

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

struct IdxStream {            // geometry of the packed index stream
  int bits, cpg, wpg, groups, words;
};

__device__ __forceinline__ uint32_t packed_entry(const uint32_t* wr, const IdxStream& s,
                                                 int i) {
  const int j = i / s.groups, g = i % s.groups;
  const int bit = j * s.bits, wi = bit >> 5, off = bit & 31;
  uint32_t u = wr[wi * s.groups + g] >> off;
  if (off + s.bits > 32) u |= wr[(wi + 1) * s.groups + g] << (32 - off);
  return u & ((1u << s.bits) - 1u);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
sparse_select_pack_kernel(const float* __restrict__ x, void* __restrict__ values,
                          uint32_t* __restrict__ idx_words, int rows, int cols, int k,
                          IdxStream st, int rows_per_cta, int topk, int half_values,
                          uint32_t seed, float rescale) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows_per_cta) return;
  const int row = blockIdx.x * rows_per_cta + warp;
  if (row >= rows) return;
  const int kpad = st.groups * st.cpg;
  uint32_t* keys = smem + warp * cols;
  uint16_t* sel = reinterpret_cast<uint16_t*>(smem + rows_per_cta * cols) + warp * kpad;
  const float* xr = x + static_cast<size_t>(row) * cols;

  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(cols);
  for (int l = lane; l < cols; l += 32) {
    uint32_t key;
    if (topk) {
      const uint32_t mag = __float_as_uint(xr[l]) & 0x7FFFFFFFu;
      key = mag > 0x7F800000u ? 0u : mag + 1u;
    } else {
      key = pcg_hash((base + static_cast<uint32_t>(l)) ^ seed);
    }
    keys[l] = key;
  }
  __syncwarp();

  unsigned long long prev = 1ull << 48;        // above every lane's value
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0ull;
    for (int l = lane; l < cols; l += 32) {
      const unsigned long long v =
          (static_cast<unsigned long long>(keys[l]) << 16) | static_cast<unsigned>(0xFFFF - l);
      if (v < prev && v > best) best = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, o);
      best = other > best ? other : best;
    }
    if (lane == 0) sel[r] = static_cast<uint16_t>(0xFFFF - (best & 0xFFFFull));
    prev = best;
  }
  __syncwarp();

  for (int i = lane; i < k; i += 32) {
    float v = xr[sel[i]];
    if (!topk) v = __fmul_rn(v, rescale);
    const size_t o = static_cast<size_t>(row) * k + i;
    if (half_values) {
      static_cast<__half*>(values)[o] = __float2half_rn(v);
    } else {
      static_cast<float*>(values)[o] = v;
    }
  }
  uint32_t* wr = idx_words + static_cast<size_t>(row) * st.words;
  for (int t = lane; t < st.words; t += 32) {
    const int wi = t / st.groups, g = t % st.groups;
    const int j0 = (32 * wi) / st.bits;
    int j1 = (32 * wi + 31) / st.bits;
    if (j1 > st.cpg - 1) j1 = st.cpg - 1;
    uint32_t word = 0u;
    for (int j = j0; j <= j1; ++j) {
      const int i = j * st.groups + g;
      const uint32_t u = i < k ? sel[i] : 0u;
      const int off = j * st.bits - 32 * wi;
      word |= off >= 0 ? u << off : u >> (-off);
    }
    wr[t] = word;
  }
}

// Lane -> slot map of one row (0xFFFF: no value), built by its warp; an
// index past cols is dropped, as the TPU kernels' compare drops it.
__device__ __forceinline__ void build_slot_map(const uint32_t* wr, const IdxStream& st, int k,
                                               int cols, uint16_t* slots, int lane) {
  for (int l = lane; l < cols; l += 32) slots[l] = 0xFFFFu;
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const uint32_t u = packed_entry(wr, st, i);
    if (u < static_cast<uint32_t>(cols)) slots[u] = static_cast<uint16_t>(i);
  }
  __syncwarp();
}

__device__ __forceinline__ float sparse_value(const void* values, size_t o, int half_values) {
  return half_values ? __half2float(static_cast<const __half*>(values)[o])
                     : static_cast<const float*>(values)[o];
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
sparse_scatter_axpy_kernel(const void* __restrict__ values,
                           const uint32_t* __restrict__ idx_words, const float* acc,
                           float* out, int rows, int cols, int k, IdxStream st,
                           int rows_per_cta, int half_values, float aw, float w) {
  extern __shared__ uint16_t slot_of[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows_per_cta) return;
  const int row = blockIdx.x * rows_per_cta + warp;
  if (row >= rows) return;
  uint16_t* slots = slot_of + warp * cols;
  build_slot_map(idx_words + static_cast<size_t>(row) * st.words, st, k, cols, slots, lane);
  const size_t vbase = static_cast<size_t>(row) * k;
  const float* ar = acc + static_cast<size_t>(row) * cols;
  float* orow = out + static_cast<size_t>(row) * cols;
  for (int l = lane; l < cols; l += 32) {
    const uint16_t s = slots[l];
    const float d = s != 0xFFFFu ? __fmul_rn(w, sparse_value(values, vbase + s, half_values))
                                 : 0.0f;
    orow[l] = __fadd_rn(__fmul_rn(aw, ar[l]), d);
  }
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
sparse_unpack_scatter_kernel(const void* __restrict__ values,
                             const uint32_t* __restrict__ idx_words, float* __restrict__ out,
                             int rows, int cols, int k, IdxStream st, int rows_per_cta,
                             int half_values) {
  extern __shared__ uint16_t slot_of[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows_per_cta) return;
  const int row = blockIdx.x * rows_per_cta + warp;
  if (row >= rows) return;
  uint16_t* slots = slot_of + warp * cols;
  build_slot_map(idx_words + static_cast<size_t>(row) * st.words, st, k, cols, slots, lane);
  const size_t vbase = static_cast<size_t>(row) * k;
  float* orow = out + static_cast<size_t>(row) * cols;
  for (int l = lane; l < cols; l += 32) {
    const uint16_t s = slots[l];
    orow[l] = s != 0xFFFFu ? __fadd_rn(0.0f, sparse_value(values, vbase + s, half_values))
                           : 0.0f;
  }
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

bool stream_for(int cols, int kpad, IdxStream* st) {
  if (cols % 128 != 0 || cols > kMaxCols) return false;
  int bits = 0;
  while ((1 << bits) < cols) ++bits;           // ceil(log2 cols); cols >= 128
  const int lcm = bits * 32 / gcd_int(bits, 32);
  st->bits = bits;
  st->cpg = lcm / bits;
  st->wpg = lcm / 32;
  if (kpad % st->cpg != 0 || kpad > cols) return false;
  st->groups = kpad / st->cpg;
  st->words = st->groups * st->wpg;
  return true;
}

int rows_per_cta_for(int cols) {
  int r = kRowLanes / cols;
  return r < 1 ? 1 : (r > kWarpsPerCta ? kWarpsPerCta : r);
}

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrappers: cols % 128 == 0,
// cols <= 8192, 1 <= k <= kpad <= cols with kpad whole stream groups, values
// f32 (half_values == 0) or f16, contiguous row-major buffers on one device.
extern "C" int sparse_select_pack_2d_launch(const void* x, void* values, void* idx_words,
                                            int rows, int cols, int k, int kpad, int topk,
                                            int half_values, unsigned int seed,
                                            float rescale, void* stream) {
  if (rows == 0) return 0;
  IdxStream st;
  if (!stream_for(cols, kpad, &st) || k < 1 || k > kpad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpc = rows_per_cta_for(cols);
  const size_t smem = static_cast<size_t>(rpc) * (cols * sizeof(uint32_t) +
                                                  kpad * sizeof(uint16_t));
  const int grid = (rows + rpc - 1) / rpc;
  sparse_select_pack_kernel<<<grid, rpc * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), values, static_cast<uint32_t*>(idx_words), rows, cols,
      k, st, rpc, topk, half_values, seed, rescale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_scatter_axpy_2d_launch(const void* values, const void* idx_words,
                                             const void* acc, void* out, int rows, int cols,
                                             int k, int kpad, int half_values, float aw,
                                             float w, void* stream) {
  if (rows == 0) return 0;
  IdxStream st;
  if (!stream_for(cols, kpad, &st) || k < 1 || k > kpad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpc = rows_per_cta_for(cols);
  const size_t smem = static_cast<size_t>(rpc) * cols * sizeof(uint16_t);
  const int grid = (rows + rpc - 1) / rpc;
  sparse_scatter_axpy_kernel<<<grid, rpc * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      values, static_cast<const uint32_t*>(idx_words), static_cast<const float*>(acc),
      static_cast<float*>(out), rows, cols, k, st, rpc, half_values, aw, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_unpack_scatter_2d_launch(const void* values, const void* idx_words,
                                               void* out, int rows, int cols, int k, int kpad,
                                               int half_values, void* stream) {
  if (rows == 0) return 0;
  IdxStream st;
  if (!stream_for(cols, kpad, &st) || k < 1 || k > kpad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpc = rows_per_cta_for(cols);
  const size_t smem = static_cast<size_t>(rpc) * cols * sizeof(uint16_t);
  const int grid = (rows + rpc - 1) / rpc;
  sparse_unpack_scatter_kernel<<<grid, rpc * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      values, static_cast<const uint32_t*>(idx_words), static_cast<float*>(out), rows, cols,
      k, st, rpc, half_values);
  return static_cast<int>(cudaGetLastError());
}

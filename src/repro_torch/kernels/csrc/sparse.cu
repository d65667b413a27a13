// Sparse select-pack (K6), sparse scatter-axpy (K6c) and sparse
// unpack-scatter (K6b): the send, the fused receive and the dense decode of
// the fixed-capacity `sparse` gossip wire, for Hopper (sm_90a).
//
// K6 `sparse_select_pack` replaces the TPU kernel `sparse_select_pack_2d`
// (src/repro/kernels/quant.py, `_sparse_select_pack_kernel`).
//   Per row of a (rows, cols) f32 fold: keep k = ceil(p*cols) elements in the
//   canonical order, descending key with ties to the smaller index.  randk:
//   key = pcg_hash((offset + row*cols + lane) ^ seed) over the whole fold
//   (counters as in K1, `offset` placing the fold in a larger one),
//   and the kept values times the f32 constant cols/k; topk: key =
//   bits(|x|) + 1, and 0 for NaN, so NaN ranks below every real magnitude and
//   -0.0 ties +0.0.  Values leave as f32 or f16 (round to nearest even); the
//   indices are stream-packed at idx_bits = ceil(log2 cols) bits into kpad
//   slots: entry i goes to group i % Gi at stream position i / Gi, the tail
//   past k is zero, word w of group g sits at column w*Gi + g.
//   Bound on this card: memory.  The row is read once (4 B an element) and
//   leaves as k values and kpad*idx_bits/32 words: at cols 128 and p 0.05,
//   512 B in and 56 B out a row.
//   What held the first design back: one warp a row with the keys in shared
//   memory, each round re-reading them and reducing a 48-bit (key, lane)
//   value through ten dependent 64-bit shuffles, then a second global read
//   of every kept value; about 9x the bytes bound at k 7.  Any design of k
//   dependent warp-wide rounds a row stays several times over the bound.
//   Design at the wire's block (128 columns) and k <= 8, the `sparse`
//   wire's p 0.05: one thread a row and no rounds (the row path below).  A
//   cheap lower bound on the row's k-th key (the k-th largest of 16 group
//   maxima) leaves about 10 candidates of 128, which go into a sorted list of
//   8 in registers; keep the loops unrolled to constant indices, since an
//   array indexed at run time lands in local memory and costs more than the
//   selection itself.
//   Design elsewhere (k > 8 at 128 columns, other widths): rounds.  Lane l of
//   a row's lanes owns the contiguous span [l*C, (l+1)*C) in registers
//   (16-byte loads) and orders it once (stable odd-even transposition:
//   neighbours swap on a strictly larger key only).  A round is one
//   `redux.sync` maximum over the live heads and one ballot; the lowest lane
//   holding the maximum wins (spans ascend, so it has the smallest column and
//   the tie-break needs no bits of the key) and shifts its head.  A used-up
//   lane is not live, so a key of 0 (NaN, a zero hash) stays ordinary and
//   p = 1 works.  Rounds go in chunks: lane t keeps round t's ballot, then
//   fetches entry t's column and value from the winner's registers by
//   shuffle (no second read); the values leave in one store and the columns
//   are OR-ed into the row's index words staged in shared memory.  Rows of
//   128 columns go two to a warp, 16 lanes of 8 columns, with a full-warp
//   reduction for each (a partial-mask `redux.sync` takes a serialised
//   path); other rows up to 1024 columns one to a warp; wider rows stage
//   values and each lane's sorted span in shared memory (stable insertion
//   sort) and run the same rounds.  CTAs are persistent and load the next
//   row while they select.

// K6c `sparse_scatter_axpy` replaces the TPU kernel `sparse_scatter_axpy_2d`
// (src/repro/kernels/quant.py, `_sparse_scatter_axpy_kernel` +
// `_sparse_idx_entries`).
//   out = aw*acc + (hit ? w*value : +0.0) per lane; acc and out may be the
//   same buffer (each element is read and then written by one thread).  An
//   index past cols is dropped, as the TPU kernel's compare drops it.
//   Bound on this card: memory.  Per element 4 B of accumulator in and 4 B
//   out (2 + 2 for a bf16 accumulator); per row k values and the index words.
//   What held the first design back (41% of its bound with a bf16
//   accumulator, 67% in f32): one warp a 128-column row paid, in series,
//   128 shared stores to clear a lane -> slot map, a dependent load of the
//   index words, two __syncwarp and only then four scalar accumulator loads
//   a lane, 256 B in flight for the warp before it retired; with 8 rows a
//   CTA no warp overlapped one row's index latency with another row's
//   stream.
//   Design at the wire's block (128 columns), k <= 8 (one index group, the
//   `sparse` wire's p 0.05) and 16-byte aligned acc and out: the rows path,
//   with no shared memory and no barrier.  Sixteen threads share a row, 8
//   columns each (one 16-byte vector of bf16, two of f32), so a warp holds 2
//   rows; CTAs are persistent and each thread has kScatterInFlight rows in
//   flight.  For all of them it first issues its accumulator vector load,
//   the row's first one or two index words (one broadcast for the 16
//   threads) and, on thread e < k, value e; none of these waits on
//   another.  Then it decodes the k 7-bit indices in
//   registers (loops unrolled to constant indices), keeps a 4-bit slot
//   (entry + 1) for each of its 8 columns that an index hits, and fetches
//   w*value of each slot from its thread by shuffle: 8 shuffles a row, the
//   same for every lane, so a row's lanes never diverge around them.  (On
//   the H100, four f32 columns a thread, one float4, ran slower; more rows
//   in flight or fewer, and 4 or 16 warps a CTA, no faster.)
//   Design elsewhere (k > 8 at 128 columns, other widths up to 8192, a view
//   that is not 16-byte aligned): one warp a row builds the lane -> slot map
//   in shared memory (`build_slot_map`, shared with K6b); each lane owns
//   4-column quads, and its first kQuadsInFlight quads are loaded (16 B, or
//   scalar accesses off alignment) before the map, so the index latency
//   overlaps the stream.  The bf16-accumulator variant
//   (`sparse_scatter_axpy_2d_bf16_launch`, the receive into bf16 estimates)
//   is the same templates on `__nv_bfloat16` (accum.cuh).
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

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxCols = 8192;              // lane and slot numbers fit 16 bits;
                                            // one row's keys and slots fit 48 KiB
constexpr int kRowLanes = 2048;             // shared-memory lanes per CTA
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSelWarps = 8;                // K6: warps per CTA
constexpr int kRegCols = 1024;              // K6: widest row held in registers
constexpr int kSelStageBytes = 96 * 1024;   // K6: shared memory of a CTA past kRegCols

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

__device__ __forceinline__ uint32_t select_key(float v, uint32_t counter, int topk,
                                               uint32_t seed) {
  if (!topk) return pcg_hash(counter ^ seed);
  const uint32_t mag = __float_as_uint(v) & 0x7FFFFFFFu;
  return mag > 0x7F800000u ? 0u : mag + 1u;
}

// One round of the selection in each of the warp's R rows (segments of
// 32/R lanes, `seg` this lane's): true on the lane whose head is its
// segment's largest live head, the lowest such lane on a tie (the spans are
// contiguous and ascending, so that lane's head has the smallest column).  A
// used-up lane is not live, so a key of 0 stays an ordinary key.  The
// reductions run over the whole warp, one a segment (a partial mask would
// serialise them).  *tops: the warp's lanes holding their segment's maximum.
template <int R>
__device__ __forceinline__ bool wins_round(bool live, uint32_t head, int seg,
                                           uint32_t lanes_below, uint32_t* tops) {
  const uint32_t h = live ? head : 0u;
  uint32_t m = 0u;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const uint32_t ms = __reduce_max_sync(kFullMask, seg == s ? h : 0u);
    m = seg == s ? ms : m;
  }
  const bool top = live && head == m;
  *tops = __ballot_sync(kFullMask, top);                    // every lane votes
  return top && (*tops & lanes_below) == 0u;
}

// Entry e of the row: its value to the value row, its column OR-ed into the
// row's index words staged in shared memory (entry e sits in group e % Gi at
// stream position e / Gi; a field that crosses a word spills into the
// group's next word).
__device__ __forceinline__ void emit_entry(void* values, uint32_t* words, const IdxStream& st,
                                           int row, int k, int e, int col, float v, int topk,
                                           int half_values, float rescale) {
  if (!topk) v = __fmul_rn(v, rescale);
  const size_t o = static_cast<size_t>(row) * k + e;
  if (half_values) {
    static_cast<__half*>(values)[o] = __float2half_rn(v);
  } else {
    static_cast<float*>(values)[o] = v;
  }
  const int j = st.groups == 1 ? e : e / st.groups, g = e - j * st.groups;
  const int bit = j * st.bits, w = (bit >> 5) * st.groups + g, off = bit & 31;
  const uint32_t u = static_cast<uint32_t>(col);
  atomicOr(words + w, u << off);
  if (off + st.bits > 32) atomicOr(words + w + st.groups, u >> (32 - off));
}

// The row's staged index words: zeroed before its entries are OR-ed in, then
// copied out whole (the tail past k stays zero), by the S lanes of its
// segment (lane sl).
__device__ __forceinline__ void zero_words(uint32_t* words, const IdxStream& st, int sl, int S) {
  if (st.words <= S) {
    if (sl < st.words) words[sl] = 0u;
  } else {
    for (int t = sl; t < st.words; t += S) words[t] = 0u;
  }
  __syncwarp();
}

__device__ __forceinline__ void store_words(const uint32_t* words, const IdxStream& st,
                                            uint32_t* wr, int sl, int S, bool valid) {
  __syncwarp();
  if (valid) {
    if (st.words <= S) {
      if (sl < st.words) wr[sl] = words[sl];
    } else {
      for (int t = sl; t < st.words; t += S) wr[t] = words[t];
    }
  }
  __syncwarp();
}

template <int C>
__device__ __forceinline__ void load_span(const float* xr, int lane, int vec, float (&v)[C]) {
  const float* s = xr + lane * C;
  if (vec) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = s[j];
  }
}

// Rows of cols = 32*C/R <= 1024, R rows a warp: a segment of S = 32/R lanes
// takes a row, and lane l of it holds columns [l*C, (l+1)*C) in registers:
// values in column order, keys (shifted out as they are taken) and span
// positions in canonical order.  Rounds go in chunks of S: lane t of a
// segment keeps round t's ballot, and after the chunk fetches entry t's
// column and value from the winner's registers, so the chunk's entries leave
// in one coalesced store.  Persistent: a warp walks groups of R rows at the
// grid's stride and loads the next group while it selects from this one.
template <int C, int R>
__global__ void __launch_bounds__(kSelWarps * 32)
sparse_select_pack_regs_kernel(const float* __restrict__ x, void* __restrict__ values,
                               uint32_t* __restrict__ idx_words, int rows, int cols, int k,
                               IdxStream st, int topk, int half_values, uint32_t seed,
                               uint32_t offset, float rescale, int vec) {
  constexpr int S = 32 / R;
  extern __shared__ uint32_t words_of[];
  const int lane = threadIdx.x & 31, seg = lane / S, sl = lane % S, lead = lane - sl;
  const uint32_t lanes_below = ((1u << lane) - 1u) & ~((1u << lead) - 1u);
  uint32_t* words = words_of + ((threadIdx.x >> 5) * R + seg) * st.words;
  const int stride = gridDim.x * kSelWarps * R;
  int row0 = (blockIdx.x * kSelWarps + (threadIdx.x >> 5)) * R;
  float next[C];
  if (row0 + seg < rows) load_span<C>(x + static_cast<size_t>(row0 + seg) * cols, sl, vec, next);
  for (; row0 < rows; row0 += stride) {
    const int row = row0 + seg;
    const bool valid = row < rows;
    float v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = next[j];
    if (row + stride < rows)
      load_span<C>(x + static_cast<size_t>(row + stride) * cols, sl, vec, next);
    uint32_t key[C];
    int at[C];                          // span position -> column in the span
    const uint32_t base = offset + static_cast<uint32_t>(row) * static_cast<uint32_t>(cols) +
                          static_cast<uint32_t>(sl * C);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      key[j] = select_key(v[j], base + static_cast<uint32_t>(j), topk, seed);
      at[j] = j;
    }
    // canonical order of the span: odd-even transposition swaps neighbours
    // on a strictly larger key only, so equal keys keep ascending columns
#pragma unroll
    for (int ph = 0; ph < C; ++ph) {
#pragma unroll
      for (int j = ph & 1; j + 1 < C; j += 2) {
        const bool up = key[j + 1] > key[j];
        const uint32_t ka = key[j], kb = key[j + 1];
        const int a = at[j], b = at[j + 1];
        key[j] = up ? kb : ka;
        key[j + 1] = up ? ka : kb;
        at[j] = up ? b : a;
        at[j + 1] = up ? a : b;
      }
    }
    constexpr int kAtWords = (C + 3) / 4;
    uint32_t at8[kAtWords];             // at[] packed, a byte each
#pragma unroll
    for (int q = 0; q < kAtWords; ++q) {
      at8[q] = 0u;
#pragma unroll
      for (int j = 4 * q; j < C && j < 4 * q + 4; ++j)
        at8[q] |= static_cast<uint32_t>(at[j]) << (8 * (j - 4 * q));
    }
    zero_words(words, st, sl, S);
    int left = valid ? C : 0;           // the head is key[0] while left > 0
    for (int r0 = 0; r0 < k; r0 += S) {
      const int n = min(S, k - r0), taken = C - left;
      uint32_t won = 0u;                // bit t: this lane won round r0 + t
      uint32_t mine = 1u << lead;       // lane t of a segment: the tops of round r0 + t
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        uint32_t tops;
        if (wins_round<R>(left > 0, key[0], seg, lanes_below, &tops)) {
#pragma unroll
          for (int j = 0; j + 1 < C; ++j) key[j] = key[j + 1];
          won |= 1u << t;
          --left;
        }
        if (sl == t) mine = tops;
      }
      // entry r0 + sl: the winner's span position is its count of earlier
      // wins, its column and value come from the winner's registers
      const int owner = __ffs(mine & (R == 1 ? kFullMask : ((1u << S) - 1u) << lead)) - 1;
      const uint32_t owner_won = __shfl_sync(kFullMask, won, owner);
      const int pos = __shfl_sync(kFullMask, taken, owner) + __popc(owner_won & ((1u << sl) - 1u));
      uint32_t a8 = 0u;
#pragma unroll
      for (int q = 0; q < kAtWords; ++q) {
        const uint32_t o = __shfl_sync(kFullMask, at8[q], owner);
        a8 = (pos >> 2) == q ? o : a8;
      }
      const int a = (a8 >> (8 * (pos & 3))) & 0xFFu;
      float val = 0.0f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float o = __shfl_sync(kFullMask, v[j], owner);
        val = a == j ? o : val;
      }
      if (valid && sl < n)
        emit_entry(values, words, st, row, k, r0 + sl, (owner - lead) * C + a, val, topk,
                   half_values, rescale);
    }
    store_words(words, st, idx_words + static_cast<size_t>(row) * st.words, sl, S, valid);
  }
}

// Rows of the wire's block (128 columns) with k <= kRowK: one thread a row,
// no rounds.  The warp stages its 32 rows in shared memory (cp.async,
// 512 contiguous bytes a copy; rows padded to kRowStride floats, so each
// thread's 16-byte reads of its own row are free of bank conflicts).  Pass
// 1: the key maximum of each of kGroups groups of 8 columns; the k-th
// largest of those maxima, lo, is a lower bound on the row's k-th key (k
// group maxima are k elements at or above it), so every kept element has a
// key >= lo.  Pass 2: a bit a column for key >= lo.  A row with more than
// kRowTrim candidates (zeros, a constant row: all tied at lo) keeps those
// above lo and only the first ties it needs.  Then the candidates (about 10
// of 128 in random rows), in ascending column, are inserted into a sorted
// list of kRowK (key, column) in registers; a strictly larger key moves
// ahead, so equal keys keep ascending columns.  An empty slot holds key 0,
// below every candidate: topk keys here are select_key's plus one, and a
// randk row holds at most one zero hash (pcg_hash is a bijection), so no
// group maximum and no lo is 0.  The loop runs while any lane of the warp
// has a candidate left; a lane with none inserts key 0, which moves nothing.
constexpr int kRowCols = 128;
constexpr int kRowStride = kRowCols + 4;
constexpr int kRowWarps = 2;
constexpr int kRowK = 8;
constexpr int kGroups = 16;
constexpr int kGroupCols = kRowCols / kGroups;
constexpr int kRowTrim = 32;                // candidates a row past which ties at lo are cut

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool TOPK>
__device__ __forceinline__ uint32_t row_key(float v, uint32_t counter, uint32_t seed) {
  if (!TOPK) return pcg_hash(counter ^ seed);
  const uint32_t mag = __float_as_uint(v) & 0x7FFFFFFFu;
  return mag > 0x7F800000u ? 1u : mag + 2u;
}

template <bool TOPK>
__global__ void __launch_bounds__(kRowWarps * 32)
sparse_select_pack_row_kernel(const float* __restrict__ x, void* __restrict__ values,
                              uint32_t* __restrict__ idx_words, int rows, int k,
                              int n_words, int half_values, uint32_t seed, uint32_t offset,
                              float rescale) {
  __shared__ __align__(16) float stage[kRowWarps][32 * kRowStride];
  const int lane = threadIdx.x & 31;
  float* s = stage[threadIdx.x >> 5];
  const int row0 = (blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * 32;
  const int n = min(32, rows - row0);
  for (int r = 0; r < n; ++r)
    cp_async16(s + r * kRowStride + 4 * lane,
               x + static_cast<size_t>(row0 + r) * kRowCols + 4 * lane);
  cp_async_wait_all();
  __syncwarp();
  const int row = row0 + lane;
  const bool valid = lane < n;
  const float* sr = s + lane * kRowStride;
  const float4* sr4 = reinterpret_cast<const float4*>(sr);
  const uint32_t base = offset + static_cast<uint32_t>(row) * static_cast<uint32_t>(kRowCols);
  // pass 1: the largest kRowK group maxima, descending, and the bound lo
  uint32_t top[kRowK];
#pragma unroll
  for (int i = 0; i < kRowK; ++i) top[i] = 0u;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    uint32_t m = 0u;
#pragma unroll
    for (int q = 0; q < kGroupCols / 4; ++q) {
      const float4 f = sr4[g * kGroupCols / 4 + q];
      const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        m = max(m, row_key<TOPK>(v[c], base + static_cast<uint32_t>(g * kGroupCols + 4 * q + c),
                                 seed));
    }
#pragma unroll
    for (int i = 0; i < kRowK; ++i) {
      const uint32_t hi = max(top[i], m);
      m = min(top[i], m);
      top[i] = hi;
    }
  }
  uint32_t lo = top[0];
#pragma unroll
  for (int i = 1; i < kRowK; ++i) lo = i < k ? min(lo, top[i]) : lo;
  // pass 2: the candidates, a bit a column
  uint32_t cand[kRowCols / 32];
#pragma unroll
  for (int w = 0; w < kRowCols / 32; ++w) {
    uint32_t bits = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 f = sr4[8 * w + q];
      const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 32 * w + 4 * q + c;
        if (row_key<TOPK>(v[c], base + static_cast<uint32_t>(col), seed) >= lo)
          bits |= 1u << (col & 31);
      }
    }
    cand[w] = valid ? bits : 0u;
  }
  // a row with many keys tied at lo (zeros, a constant row) keeps only the
  // first ties it needs, k less its keys above lo, in ascending column
  const int count = __popc(cand[0]) + __popc(cand[1]) + __popc(cand[2]) + __popc(cand[3]);
  if (__any_sync(kFullMask, count > kRowTrim)) {
    uint32_t above[kRowCols / 32];
    int need = k;
#pragma unroll
    for (int w = 0; w < kRowCols / 32; ++w) {
      uint32_t bits = 0u;
#pragma unroll 1
      for (int j = 0; j < 32; ++j) {
        const int col = 32 * w + j;
        if (row_key<TOPK>(sr[col], base + static_cast<uint32_t>(col), seed) > lo)
          bits |= 1u << j;
      }
      above[w] = bits & cand[w];
      need -= __popc(above[w]);
    }
#pragma unroll
    for (int w = 0; w < kRowCols / 32; ++w) {
      uint32_t tie = cand[w] & ~above[w];
      for (int drop = __popc(tie) - max(need, 0); drop > 0; --drop)
        tie &= ~(0x80000000u >> __clz(tie));          // the highest tie goes
      need -= __popc(tie);
      cand[w] = above[w] | tie;
    }
  }
  // the candidates into the sorted list, in ascending column
  uint32_t lk[kRowK];
  int lc[kRowK];
#pragma unroll
  for (int i = 0; i < kRowK; ++i) {
    lk[i] = 0u;
    lc[i] = 0;
  }
  while (__any_sync(kFullMask, (cand[0] | cand[1] | cand[2] | cand[3]) != 0u)) {
    int col = 0;
    uint32_t key = 0u;
    bool found = false;
#pragma unroll
    for (int w = 0; w < kRowCols / 32; ++w) {
      if (!found && cand[w] != 0u) {
        col = 32 * w + __ffs(cand[w]) - 1;
        cand[w] &= cand[w] - 1u;
        found = true;
      }
    }
    if (found) key = row_key<TOPK>(sr[col], base + static_cast<uint32_t>(col), seed);
    bool gt[kRowK];
#pragma unroll
    for (int i = 0; i < kRowK; ++i) gt[i] = key > lk[i];
#pragma unroll
    for (int i = kRowK - 1; i > 0; --i) {
      lk[i] = gt[i] ? (gt[i - 1] ? lk[i - 1] : key) : lk[i];
      lc[i] = gt[i] ? (gt[i - 1] ? lc[i - 1] : col) : lc[i];
    }
    lk[0] = gt[0] ? key : lk[0];
    lc[0] = gt[0] ? col : lc[0];
  }
  if (!valid) return;
  // entry e: its value, its column at stream bit 7e (one group at 128 columns)
  uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
  for (int e = 0; e < kRowK; ++e) {
    if (e < k) {
      float v = sr[lc[e]];
      if (!TOPK) v = __fmul_rn(v, rescale);
      const size_t o = static_cast<size_t>(row) * k + e;
      if (half_values) {
        static_cast<__half*>(values)[o] = __float2half_rn(v);
      } else {
        static_cast<float*>(values)[o] = v;
      }
      const uint32_t u = static_cast<uint32_t>(lc[e]);
      if (7 * e < 32) w0 |= u << (7 * e);
      if (7 * e + 7 > 32) w1 |= 7 * e < 32 ? u >> (32 - 7 * e) : u << (7 * e - 32);
    }
  }
  uint32_t* wr = idx_words + static_cast<size_t>(row) * n_words;
  wr[0] = w0;
  wr[1] = w1;
  for (int w = 2; w < n_words; ++w) wr[w] = 0u;
}

// Rows of cols > 1024: the same rounds over spans staged in shared memory.
// Per warp: the row's values, each lane's span sorted in canonical order
// (stable insertion sort of keys and 16-bit columns), and the index words.
__global__ void __launch_bounds__(kSelWarps * 32)
sparse_select_pack_smem_kernel(const float* __restrict__ x, void* __restrict__ values,
                               uint32_t* __restrict__ idx_words, int rows, int cols, int k,
                               IdxStream st, int topk, int half_values, uint32_t seed,
                               uint32_t offset, float rescale) {
  extern __shared__ uint32_t stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  const int c = cols / 32, b = lane * c;
  float* sval = reinterpret_cast<float*>(stage + warp * (2 * cols + st.words + cols / 2));
  uint32_t* skey = reinterpret_cast<uint32_t*>(sval + cols);
  uint32_t* words = skey + cols;
  uint16_t* scol = reinterpret_cast<uint16_t*>(words + st.words);
  for (int row = blockIdx.x * warps + warp; row < rows; row += gridDim.x * warps) {
    const float* xr = x + static_cast<size_t>(row) * cols;
    for (int l = lane; l < cols; l += 32) sval[l] = xr[l];
    __syncwarp();
    const uint32_t base = offset + static_cast<uint32_t>(row) * static_cast<uint32_t>(cols);
    for (int j = 0; j < c; ++j) {
      const uint32_t key = select_key(sval[b + j], base + static_cast<uint32_t>(b + j), topk,
                                      seed);
      int i = j;
      for (; i > 0 && skey[b + i - 1] < key; --i) {
        skey[b + i] = skey[b + i - 1];
        scol[b + i] = scol[b + i - 1];
      }
      skey[b + i] = key;
      scol[b + i] = static_cast<uint16_t>(b + j);
    }
    zero_words(words, st, lane, 32);
    int h = 0;                          // the head is skey[b + h] while h < c
    for (int r0 = 0; r0 < k; r0 += 32) {
      const int n = min(32, k - r0), taken = h;
      uint32_t won = 0u, tops;
      for (int t = 0; t < n; ++t) {
        if (wins_round<1>(h < c, h < c ? skey[b + h] : 0u, 0, lanes_below, &tops)) {
          won |= 1u << t;
          ++h;
        }
      }
      int pos = taken;
      for (uint32_t w = won; w != 0u; w &= w - 1u, ++pos) {
        const int col = scol[b + pos];
        emit_entry(values, words, st, row, k, r0 + __ffs(w) - 1, col, sval[col], topk,
                   half_values, rescale);
      }
    }
    store_words(words, st, idx_words + static_cast<size_t>(row) * st.words, lane, 32, true);
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

// The slot-map path of K6c: one warp a row, lane l owning the 4-column quads
// l, l + 32, ... (cols/128 of them), kQuadsInFlight at a time.
constexpr int kQuadsInFlight = 4;

template <typename Acc>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
sparse_scatter_axpy_kernel(const void* __restrict__ values,
                           const uint32_t* __restrict__ idx_words, const Acc* acc,
                           Acc* out, int rows, int cols, int k, IdxStream st,
                           int rows_per_cta, int half_values, float aw, float w, int vec) {
  extern __shared__ uint16_t slot_of[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows_per_cta) return;
  const int row = blockIdx.x * rows_per_cta + warp;
  if (row >= rows) return;
  uint16_t* slots = slot_of + warp * cols;
  const size_t vbase = static_cast<size_t>(row) * k;
  const Acc* ar = acc + static_cast<size_t>(row) * cols;
  Acc* orow = out + static_cast<size_t>(row) * cols;
  const int quads = cols / 128;                  // a lane's, the same on every lane
  for (int q0 = 0; q0 < quads; q0 += kQuadsInFlight) {
    accum::Vec<Acc, 4> a[kQuadsInFlight];
#pragma unroll
    for (int u = 0; u < kQuadsInFlight; ++u)
      if (q0 + u < quads) a[u] = accum::load_vec<4>(ar, 4 * (lane + 32 * (q0 + u)), vec);
    if (q0 == 0)                                 // after the first loads are issued
      build_slot_map(idx_words + static_cast<size_t>(row) * st.words, st, k, cols, slots, lane);
#pragma unroll
    for (int u = 0; u < kQuadsInFlight; ++u) {
      if (q0 + u >= quads) break;
      const int l0 = 4 * (lane + 32 * (q0 + u));
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint16_t sl = slots[l0 + e];
        const float d = sl != 0xFFFFu ? __fmul_rn(w, sparse_value(values, vbase + sl, half_values))
                                      : 0.0f;
        o[e] = __fadd_rn(__fmul_rn(aw, a[u].get(e)), d);
      }
      accum::store_vec<4>(orow, l0, o, vec);
    }
  }
}

// The rows path of K6c (128 columns, one index group, k <= kRowK): 16
// threads a row, thread t of a row owning columns 8t..8t+7 (one 16-byte
// access of bf16, two of f32); a warp's step is 2*kScatterInFlight rows,
// row r0 + 2u + (lane >= 16).  Entry e's index sits at stream bit 7e.  Rows
// past the last are computed on the last row (every lane takes part in
// every shuffle) and not stored.
constexpr int kScatterWarps = 8;
constexpr int kScatterInFlight = 8;
constexpr int kScatterCols = 8;                  // columns a thread

template <typename Acc>
__global__ void __launch_bounds__(kScatterWarps * 32)
sparse_scatter_axpy_rows_kernel(const void* __restrict__ values,
                                const uint32_t* __restrict__ idx_words, const Acc* acc,
                                Acc* out, int rows, int k, int n_words, int half_values,
                                float aw, float w) {
  const int lane = threadIdx.x & 31, t = lane & 15, half = lane >> 4;
  const int col0 = t * kScatterCols;
  const long long steps = (static_cast<long long>(rows) + 2 * kScatterInFlight - 1) /
                          (2 * kScatterInFlight);
  const bool two_words = k > 4;                  // 7k > 32 bits
  for (long long g = static_cast<long long>(blockIdx.x) * kScatterWarps + (threadIdx.x >> 5);
       g < steps; g += static_cast<long long>(gridDim.x) * kScatterWarps) {
    const int r0 = static_cast<int>(g * 2 * kScatterInFlight);
    accum::Vec<Acc, kScatterCols> a[kScatterInFlight];
    uint32_t w0[kScatterInFlight], w1[kScatterInFlight];
    float val[kScatterInFlight];
#pragma unroll
    for (int u = 0; u < kScatterInFlight; ++u) {
      const size_t row = static_cast<size_t>(min(r0 + 2 * u + half, rows - 1));
      a[u] = accum::load_vec<kScatterCols>(acc, row * kRowCols + col0, true);
      const uint32_t* wr = idx_words + row * n_words;
      w0[u] = __ldg(wr);
      w1[u] = two_words ? __ldg(wr + 1) : 0u;
      val[u] = t < k ? sparse_value(values, row * k + t, half_values) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kScatterInFlight; ++u) {
      const float wv = __fmul_rn(w, val[u]);
      uint32_t slots = 0u;                       // nibble c: entry + 1 hitting column col0 + c
#pragma unroll
      for (int e = 0; e < kRowK; ++e) {
        if (e < k) {
          const uint32_t idx =
              (7 * e < 32 ? __funnelshift_r(w0[u], w1[u], 7 * e) : w1[u] >> (7 * e - 32)) &
              0x7Fu;
          const uint32_t c = idx - static_cast<uint32_t>(col0);
          if (c < kScatterCols)
            slots = (slots & ~(0xFu << (4 * c))) | static_cast<uint32_t>(e + 1) << (4 * c);
        }
      }
      float o[kScatterCols];
#pragma unroll
      for (int c = 0; c < kScatterCols; ++c) {
        const int nib = (slots >> (4 * c)) & 0xF;
        const float d = __shfl_sync(kFullMask, wv, nib ? (lane & 16) + nib - 1 : lane);
        o[c] = __fadd_rn(__fmul_rn(aw, a[u].get(c)), nib ? d : 0.0f);
      }
      const int row = r0 + 2 * u + half;
      if (row < rows)
        accum::store_vec<kScatterCols>(out, static_cast<size_t>(row) * kRowCols + col0, o, true);
    }
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

// Enough CTAs of `warps` warps to fill every SM at the kernel's occupancy,
// and no more than the rows need.  The CTAs that fit the device are looked up
// once for each kernel (each template instance is a kernel of its own),
// device and shared-memory size, and kept in a small table keyed by all
// three.
struct GridFit {
  const void* kernel;
  int dev;
  size_t smem;
  int fit;
};
constexpr int kGridFits = 32;

int persistent_grid(const void* kernel, int rows, int warps, size_t smem) {
  thread_local GridFit fits[kGridFits];
  thread_local int n_fits = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  int fit = 0;
  for (int i = 0; i < std::min(n_fits, kGridFits) && fit == 0; ++i)
    if (fits[i].kernel == kernel && fits[i].dev == dev && fits[i].smem == smem)
      fit = fits[i].fit;
  if (fit == 0) {
    int sms = 1, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
    fit = std::max(1, per_sm) * sms;
    fits[n_fits++ % kGridFits] = GridFit{kernel, dev, smem, fit};
  }
  const long long need = (static_cast<long long>(rows) + warps - 1) / warps;
  return static_cast<int>(std::min<long long>(need, fit));
}

template <int C, int R>
int launch_select_regs(const float* x, void* values, uint32_t* words, int rows, int cols,
                       int k, const IdxStream& st, int topk, int half_values, uint32_t seed,
                       uint32_t offset, float rescale, int vec, cudaStream_t s, bool launch) {
  const size_t smem = static_cast<size_t>(kSelWarps) * R * st.words * sizeof(uint32_t);
  const void* kernel = reinterpret_cast<const void*>(sparse_select_pack_regs_kernel<C, R>);
  const int grid = persistent_grid(kernel, (rows + R - 1) / R, kSelWarps, smem);
  if (launch)
    sparse_select_pack_regs_kernel<C, R><<<grid, kSelWarps * 32, smem, s>>>(
        x, values, words, rows, cols, k, st, topk, half_values, seed, offset, rescale, vec);
  return grid;
}

// Launches K6 on the path its shape takes and returns the grid; with
// `launch` false it only returns the grid (-1 for a shape no path takes).
int select_pack(const float* xf, void* values, uint32_t* words, int rows, int cols, int k,
                const IdxStream& st, int topk, int half_values, uint32_t seed, uint32_t offset,
                float rescale, int vec, cudaStream_t s, bool launch) {
  if (cols == kRowCols && st.groups == 1 && k <= kRowK && vec) {
    const int grid = (rows + kRowWarps * 32 - 1) / (kRowWarps * 32);
    if (!launch) return grid;
    if (topk) {
      sparse_select_pack_row_kernel<true><<<grid, kRowWarps * 32, 0, s>>>(
          xf, values, words, rows, k, st.words, half_values, seed, offset, rescale);
    } else {
      sparse_select_pack_row_kernel<false><<<grid, kRowWarps * 32, 0, s>>>(
          xf, values, words, rows, k, st.words, half_values, seed, offset, rescale);
    }
    return grid;
  }
  if (cols <= kRegCols) {
    switch (cols / 32) {
#define K6_REGS(C, R)                                                                   \
  case (C) / (R):                                                                       \
    return launch_select_regs<(C), (R)>(xf, values, words, rows, cols, k, st, topk,     \
                                        half_values, seed, offset, rescale, vec, s, launch);
      K6_REGS(8, 2)     // the sparse wire's block: two rows a warp, 8 columns a lane
      K6_REGS(8, 1) K6_REGS(12, 1) K6_REGS(16, 1) K6_REGS(20, 1) K6_REGS(24, 1) K6_REGS(28, 1)
      K6_REGS(32, 1)
#undef K6_REGS
      default:
        return -1;
    }
  }
  // per warp: values and keys (4 B a column), index words, 16-bit columns
  const size_t per_warp =
      (2 * static_cast<size_t>(cols) + st.words + cols / 2) * sizeof(uint32_t);
  const int warps = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(kSelWarps, kSelStageBytes / per_warp)));
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sparse_select_pack_smem_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return -1;
  }
  const int grid = persistent_grid(reinterpret_cast<const void*>(sparse_select_pack_smem_kernel),
                                   rows, warps, smem);
  if (launch)
    sparse_select_pack_smem_kernel<<<grid, warps * 32, smem, s>>>(
        xf, values, words, rows, cols, k, st, topk, half_values, seed, offset, rescale);
  return grid;
}

// K6c takes the rows path at 128 columns, one index group, k <= kRowK and a
// 16-byte aligned acc and out (`vec`), else the slot-map path.
bool scatter_rows_path(int cols, int k, const IdxStream& st, int vec) {
  return cols == kRowCols && st.groups == 1 && k <= kRowK && vec;
}

template <typename Acc>
int launch_scatter_axpy(const void* values, const void* idx_words, const void* acc, void* out,
                        int rows, int cols, int k, int kpad, int half_values, float aw,
                        float w, void* stream) {
  if (rows == 0) return 0;
  IdxStream st;
  if (!stream_for(cols, kpad, &st) || k < 1 || k > kpad)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* words = static_cast<const uint32_t*>(idx_words);
  const auto* a = static_cast<const Acc*>(acc);
  auto* o = static_cast<Acc*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int vec =
      ((reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (scatter_rows_path(cols, k, st, vec)) {
    const void* kernel = reinterpret_cast<const void*>(sparse_scatter_axpy_rows_kernel<Acc>);
    const long long steps = (static_cast<long long>(rows) + 2 * kScatterInFlight - 1) /
                            (2 * kScatterInFlight);
    const int grid = persistent_grid(kernel, static_cast<int>(steps), kScatterWarps, 0);
    sparse_scatter_axpy_rows_kernel<Acc><<<grid, kScatterWarps * 32, 0, s>>>(
        values, words, a, o, rows, k, st.words, half_values, aw, w);
    return static_cast<int>(cudaGetLastError());
  }
  const int rpc = rows_per_cta_for(cols);
  const size_t smem = static_cast<size_t>(rpc) * cols * sizeof(uint16_t);
  const int grid = (rows + rpc - 1) / rpc;
  sparse_scatter_axpy_kernel<Acc><<<grid, rpc * 32, smem, s>>>(
      values, words, a, o, rows, cols, k, st, rpc, half_values, aw, w, vec);
  return static_cast<int>(cudaGetLastError());
}

// Every K6c kernel instance, for `sparse_kernel_attrs`
struct KernelEntry {
  const char* name;
  const void* fn;
};
const KernelEntry kScatterAxpyKernels[] = {
    {"sparse_scatter_axpy_rows_kernel<float>",
     reinterpret_cast<const void*>(sparse_scatter_axpy_rows_kernel<float>)},
    {"sparse_scatter_axpy_rows_kernel<bf16>",
     reinterpret_cast<const void*>(sparse_scatter_axpy_rows_kernel<__nv_bfloat16>)},
    {"sparse_scatter_axpy_kernel<float>",
     reinterpret_cast<const void*>(sparse_scatter_axpy_kernel<float>)},
    {"sparse_scatter_axpy_kernel<bf16>",
     reinterpret_cast<const void*>(sparse_scatter_axpy_kernel<__nv_bfloat16>)},
};

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrappers: cols % 128 == 0,
// cols <= 8192, 1 <= k <= kpad <= cols with kpad whole stream groups, values
// f32 (half_values == 0) or f16, contiguous row-major buffers on one device.
extern "C" int sparse_select_pack_2d_launch(const void* x, void* values, void* idx_words,
                                            int rows, int cols, int k, int kpad, int topk,
                                            int half_values, unsigned int seed,
                                            unsigned int offset, float rescale, void* stream) {
  if (rows == 0) return 0;
  IdxStream st;
  if (!stream_for(cols, kpad, &st) || k < 1 || k > kpad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const int grid = select_pack(static_cast<const float*>(x), values,
                               static_cast<uint32_t*>(idx_words), rows, cols, k, st, topk,
                               half_values, seed, offset, rescale, vec,
                               static_cast<cudaStream_t>(stream), true);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The grid K6 takes for (rows, cols, k, kpad) from a 16-byte aligned input,
// without launching; -1 for a shape the launcher refuses.
extern "C" int sparse_select_pack_2d_grid(int rows, int cols, int k, int kpad) {
  IdxStream st;
  if (rows < 1 || !stream_for(cols, kpad, &st) || k < 1 || k > kpad) return -1;
  return select_pack(nullptr, nullptr, nullptr, rows, cols, k, st, 1, 0, 0u, 0u, 1.0f, 1,
                     nullptr, false);
}

extern "C" int sparse_scatter_axpy_2d_launch(const void* values, const void* idx_words,
                                             const void* acc, void* out, int rows, int cols,
                                             int k, int kpad, int half_values, float aw,
                                             float w, void* stream) {
  return launch_scatter_axpy<float>(values, idx_words, acc, out, rows, cols, k, kpad,
                                    half_values, aw, w, stream);
}

// K6c with a bfloat16 accumulator (accum.cuh): the same arithmetic in f32
extern "C" int sparse_scatter_axpy_2d_bf16_launch(const void* values, const void* idx_words,
                                                  const void* acc, void* out, int rows,
                                                  int cols, int k, int kpad, int half_values,
                                                  float aw, float w, void* stream) {
  return launch_scatter_axpy<__nv_bfloat16>(values, idx_words, acc, out, rows, cols, k, kpad,
                                            half_values, aw, w, stream);
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

// The path K6c takes for (cols, k, kpad) with acc and out at these
// addresses, without launching: 1 the rows path, 0 the slot-map path, -1 a
// shape the launcher refuses.
extern "C" int sparse_scatter_axpy_2d_path(int cols, int k, int kpad, const void* acc,
                                           const void* out) {
  IdxStream st;
  if (!stream_for(cols, kpad, &st) || k < 1 || k > kpad) return -1;
  const int vec =
      ((reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  return scatter_rows_path(cols, k, st, vec) ? 1 : 0;
}

// Registers and local (spill) bytes of K6c's kernel instance i, from
// cudaFuncGetAttributes, and its name (at most len - 1 characters): 0, a
// CUDA error, or -1 past the last instance.
extern "C" int sparse_kernel_attrs(int i, int* regs, int* local_bytes, char* name, int len) {
  const int n = static_cast<int>(sizeof(kScatterAxpyKernels) / sizeof(kScatterAxpyKernels[0]));
  if (i < 0 || i >= n) return -1;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kScatterAxpyKernels[i].fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  std::strncpy(name, kScatterAxpyKernels[i].name, len - 1);
  name[len - 1] = '\0';
  return 0;
}

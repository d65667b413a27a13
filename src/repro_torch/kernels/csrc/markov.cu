// The data layer's Markov walk, for Hopper (sm_90a): every row's token walk
// of a batch in one launch.
//
// `markov_walk` replaces no TPU kernel: the JAX package samples its walk
// from a dense (vocab, vocab) logit matrix with threefry keys.  It replaces
// the eager walk of the port's data pipeline (kernels/ref.py
// `markov_walk_ref`), which ran about 134 elementwise passes over a
// (rows, vocab) tensor a position, each its own launch.
//   walk[r, 0]     = pcg(key[r]) % vocab
//   walk[r, p + 1] = argmax_c  normal(B ^ c) * (1/concentration) + gumbel(A ^ c)
//   A = pcg(pcg(pcg(key[r]) ^ p)),  B = pcg(pcg(pcg(seed + 7919) ^ walk[r, p]))
// with normal() Box-Muller on two PCG-hash uniforms (h and pcg(h ^
// 0x9E3779B9)) and gumbel() = -log(-log(uniform)).  The argmax keeps the
// lowest index among equal maxima, as torch.argmax does.
//   Bound on this card: operations.  Three hashes, three logf, one cosf and
//   one sqrt a candidate (a few hundred instructions) and nothing read from
//   device memory: rows x length x vocab candidates, 403 M at 32 x 256 x
//   49,155.  The walk is serial over positions and independent over rows.
//   Design: a thread-block cluster a row, of C CTAs (C from the rows alone,
//   kernels/markov.py `cluster_size`, so a batch of 8 rows still fills 128
//   SMs).  CTA k of a cluster scans a contiguous slice of ceil(vocab / C)
//   candidates, each thread every kThreads-th of them in increasing order;
//   (score, index) pairs reduce by warp shuffle, then over the warps in
//   shared memory, into the CTA's slot `pos & 1`.  One cluster barrier, then
//   every warp reads the C slots over distributed shared memory and reduces
//   them itself, so every thread knows the next token without a second
//   barrier.  Double-buffered slots make that safe: a CTA writes slot
//   `pos & 1` again only after the barrier of position pos + 1, which every
//   reader of position pos has reached.  Rank 0 writes the token; a last
//   cluster barrier keeps each CTA's shared memory alive until the others
//   have read it.  On the H100, 256 threads a CTA: 512 ran the 8 x 50,280 x
//   1,024 walk in 8.32 ms against 6.89 (the card holds 28 clusters of 16
//   such CTAs at once, against 58) and 1,024 in 12.5 ms, with the 32 x
//   49,155 x 256 walk within 3% at all three.
//
// Exactness: the tokens are bit-equal to the eager walk on the card.  The
// hash is uint32 arithmetic (the eager int64 code masks to 32 bits at every
// step), every float product and sum is a _rn intrinsic so nvcc cannot
// contract it into an FMA, and the scalars are those torch's elementwise
// kernels use: -2.0 and 2*pi as f32, the division by the concentration a
// product with the f32 reciprocal (torch's CUDA `div` by a host scalar).
// logf, cosf and the sqrt are the accurate ones (no fast-math).  Scores are
// finite or +inf (a uniform of exactly 1.0 gives an infinite Gumbel), never
// NaN.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;            // the largest (non-portable) cluster
constexpr uint32_t kGolden = 0x9E3779B9u;  // the second uniform's stream
constexpr uint32_t kTransitionSalt = 7919u;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwo24 = 5.9604644775390625e-8f;  // 2^-24

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// f32 uniform in (0, 1]: ((h >> 8) + 0.5) / 2^24, the sum rounded to f32
__device__ __forceinline__ float uniform_open(uint32_t h) {
  return __fmul_rn(__fadd_rn(static_cast<float>(h >> 8), 0.5f), kInvTwo24);
}

// Candidate c's score: its transition logit from the current token (hash
// seed b) plus its Gumbel noise at this position (hash seed a).
__device__ __forceinline__ float candidate_score(uint32_t a, uint32_t b, uint32_t c,
                                                 float inv_conc) {
  const float gumbel = -logf(-logf(uniform_open(pcg(a ^ c))));
  const uint32_t h = pcg(b ^ c);
  const float radius = __fsqrt_rn(__fmul_rn(-2.0f, logf(uniform_open(h))));
  const float angle = __fmul_rn(kTwoPi, uniform_open(pcg(h ^ kGolden)));
  const float normal = __fmul_rn(radius, cosf(angle));
  return __fadd_rn(__fmul_rn(normal, inv_conc), gumbel);
}

__device__ __forceinline__ uint32_t position_seed(uint32_t key_hash, int pos) {
  return pcg(pcg(key_hash ^ static_cast<uint32_t>(pos)));
}

__device__ __forceinline__ uint32_t token_seed(uint32_t seed_hash, int tok) {
  return pcg(pcg(seed_hash ^ static_cast<uint32_t>(tok)));
}

// (s, i) beats (bs, bi): a higher score, or the same score at a lower index
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Every lane ends with the warp's best pair.
__device__ __forceinline__ void warp_best(float& bs, int& bi) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float s = __shfl_xor_sync(0xffffffffu, bs, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    if (beats(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
}

// Grid: rows * C CTAs of kThreads, clusters of C along x; row r is cluster r.
__global__ void __launch_bounds__(kThreads) markov_walk_kernel(
    const int64_t* __restrict__ key, int64_t* __restrict__ walk, int vocab, int length,
    uint32_t seed_word, float inv_conc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / csize;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  __shared__ float slot_score[2];
  __shared__ int slot_index[2];
  __shared__ float warp_score[kWarps];
  __shared__ int warp_index[kWarps];

  const uint32_t key_hash = pcg(static_cast<uint32_t>(key[row]));
  const uint32_t seed_hash = pcg(seed_word + kTransitionSalt);
  int64_t* out = walk + static_cast<int64_t>(row) * (length + 1);
  int tok = static_cast<int>(key_hash % static_cast<uint32_t>(vocab));
  const bool writer = rank == 0 && threadIdx.x == 0;
  if (writer) out[0] = tok;

  const int span = (vocab + csize - 1) / csize;
  const int lo = min(rank * span, vocab), hi = min(lo + span, vocab);
  for (int pos = 0; pos < length; ++pos) {
    const uint32_t a = position_seed(key_hash, pos), b = token_seed(seed_hash, tok);
    float bs = -CUDART_INF_F;
    int bi = INT_MAX;
#pragma unroll 4
    for (int c = lo + threadIdx.x; c < hi; c += kThreads) {
      const float s = candidate_score(a, b, static_cast<uint32_t>(c), inv_conc);
      if (s > bs) {  // increasing c: the first of equal maxima stays
        bs = s;
        bi = c;
      }
    }
    warp_best(bs, bi);
    if (lane == 0) {
      warp_score[warp] = bs;
      warp_index[warp] = bi;
    }
    __syncthreads();
    const int buf = pos & 1;
    if (warp == 0) {
      bs = lane < kWarps ? warp_score[lane] : -CUDART_INF_F;
      bi = lane < kWarps ? warp_index[lane] : INT_MAX;
      warp_best(bs, bi);
      if (lane == 0) {
        slot_score[buf] = bs;
        slot_index[buf] = bi;
      }
    }
    cluster.sync();
    bs = -CUDART_INF_F;
    bi = INT_MAX;
    if (lane < csize) {
      bs = cluster.map_shared_rank(slot_score, lane)[buf];
      bi = cluster.map_shared_rank(slot_index, lane)[buf];
    }
    warp_best(bs, bi);
    tok = bi;
    if (writer) out[pos + 1] = tok;
  }
  cluster.sync();
}

// One position's scores, (rows, vocab) f32, from the same device function:
// the check that each float step rounds as the eager walk's, which an
// unchanged argmax could hide.  Grid (ceil(vocab / kThreads), rows).
__global__ void __launch_bounds__(kThreads) markov_scores_kernel(
    const int64_t* __restrict__ key, const int64_t* __restrict__ tok, float* __restrict__ out,
    int vocab, int pos, uint32_t seed_word, float inv_conc) {
  const int row = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= vocab) return;
  const uint32_t a = position_seed(pcg(static_cast<uint32_t>(key[row])), pos);
  const uint32_t b = token_seed(pcg(seed_word + kTransitionSalt),
                                static_cast<int>(tok[row]));
  out[static_cast<int64_t>(row) * vocab + c] =
      candidate_score(a, b, static_cast<uint32_t>(c), inv_conc);
}

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrapper (kernels/markov.py): key is
// (rows, 1) int64 in [0, 2^32), walk (rows, length + 1) int64, both
// contiguous on one device; cluster a power of two in 1..16.

extern "C" int markov_walk_launch(const void* key, void* walk, int rows, int vocab,
                                  int length, uint32_t seed_word, float inv_conc, int cluster,
                                  void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || vocab < 1 || length < 0 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) || rows > INT_MAX / cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(markov_walk_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, markov_walk_kernel, static_cast<const int64_t*>(key),
                         static_cast<int64_t*>(walk), vocab, length, seed_word, inv_conc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int markov_scores_launch(const void* key, const void* tok, void* out, int rows,
                                    int vocab, int pos, uint32_t seed_word, float inv_conc,
                                    void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || rows > 65535 || vocab < 1 || pos < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((vocab + kThreads - 1) / kThreads, rows);
  markov_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<const int64_t*>(tok),
      static_cast<float*>(out), vocab, pos, seed_word, inv_conc);
  return static_cast<int>(cudaGetLastError());
}

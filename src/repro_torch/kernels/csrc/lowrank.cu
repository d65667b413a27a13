// Low-rank project (K7a) and low-rank axpy (K7b): the send-side projection
// and the receive kernel of the `lowrank:<r>[:warm]` (PowerGossip) gossip
// wire, for Hopper (sm_90a).
//
// K7a `lowrank_project` replaces the TPU kernel `lowrank_project_2d`
// (src/repro/kernels/lowrank.py, `_lowrank_project_kernel`).
//   P[b] = M[b] @ V[b] for a batch of (rows, n) f32 leaf views and (n, r)
//   right factors; V's batch stride may be 0 (the cold factor, one (n, r)
//   start shared by every node and layer).
//   Bound on this card: memory.  M is read once (4 B an element); V is
//   n*r*4 B per batch and stays in L2 (395 KB at the lm_head leaf, rank 2);
//   the r*2 operations an element are far below the f32 rate.
//   Design: the Pallas kernel keeps the whole (n, r) factor in VMEM, which
//   would not fit a CTA's shared memory at n = 49408, so V is read through
//   the read-only path (__ldg) and shared by the rows of a warp instead.
//   One warp owns kRowsPerWarp rows; lane l walks j = 32k + l for k = 0, 1,
//   ..., so each step loads 128 consecutive bytes of every row, and keeps
//   one running sum per (row, rank) in registers.  Ranks are taken kRankChunk
//   at a time, one chunk per grid.z, so any rank 1..128 fits the registers.
//   The sum over n has one fixed order, spelled out in the plain version
//   (kernels/ref.py `lowrank_project_2d_ref`): each lane adds its products
//   onto +0.0 in k order, then a halving tree over the lanes (shfl_down 16,
//   8, 4, 2, 1).  Columns past n add +0.0 (zero M times zero V).
//
// K7b `lowrank_axpy` replaces the TPU kernel `lowrank_axpy_2d`
// (src/repro/kernels/lowrank.py, `_lowrank_axpy_kernel`).
//   out[b] = aw*acc[b] + w*(P[b] @ V[b]^T), P (rows, r), V (n, r); acc and
//   out may be the same buffer (each element is read and then written by
//   one thread).
//   Bound on this card: memory.  4 B of accumulator in and 4 B out an
//   element (2 + 2 for a bf16 accumulator); the factors are (rows + n)*r*4 B
//   per batch.  At rank r the reconstruction costs 2r operations an
//   element, below the f32 rate up to r of about 20 at 3.35 TB/s.
//   What held the first design back (46% of its bound with a bf16
//   accumulator, 74% in f32): a thread owned one column of a CTA of 16 rows,
//   so each CTA first staged its V tile with a dependent load before its
//   first accumulator load, each element paid r broadcast loads of P and r
//   shared-memory loads in a loop bounded at run time, and the accumulator
//   moved one scalar 2-byte access a thread, half the bytes in flight of
//   the f32 kernel for the same instructions.
//   Design at ranks 1, 2 and 4 (the rows path, templated on the exact
//   rank), for 16-byte aligned acc and out and up to 65535*kAxpyRows rows:
//   thread t of a CTA owns the columns of one 16-byte accumulator vector (4
//   f32 or 8 bf16, so a warp moves 512 contiguous bytes an instruction) and
//   holds their V[j, 0..r-1] in registers; the CTA takes kAxpyRows rows,
//   whose P it stages in shared memory once, and each thread issues the
//   accumulator loads of 8 (f32) or 4 (bf16) rows before it computes the
//   first (rows past the CTA's last re-load that row and store nothing).
//   On the H100 at the lm_head leaf two float4s a thread at +0 and +16 B
//   (8 f32 columns, each instruction taking half of every sector) ran
//   slower than one, and 64 rows a CTA slower than 8.
//   dot = P[i,0]*V[j,0], then + P[i,c]*V[j,c] for c = 1..r-1: exactly r
//   products, never a padded 0*0, whose +0.0 would turn a -0.0 dot into
//   +0.0.  Every other rank up to 128, a view that is not 16-byte aligned
//   and a slab past 65535*kAxpyRows rows take the scalar path: thread t
//   owns one column of a CTA of kRowTile rows and stages its own
//   V[j, 0..r-1] in shared memory (r*kTile*4 B, up to 128 KB at rank 128),
//   then walks the rows.
//   The bf16-accumulator variant (`lowrank_axpy_2d_bf16_launch`, the receive
//   into bf16 replicas) is the same templates on `__nv_bfloat16`
//   (accum.cuh).  The reconstruction never exists in device memory.
//
// Exactness: both kernels are bit-equal to the plain PyTorch versions in
// kernels/ref.py.  Every product and sum is written with a _rn intrinsic,
// so nvcc cannot contract it into an FMA.  A node's result depends only on
// its own batch slice, never on its position in the batch.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

constexpr int kWarps = 8;             // K7a: warps per CTA
constexpr int kRowsPerWarp = 4;       // K7a: rows sharing one warp's V loads
constexpr int kRankChunk = 8;         // K7a: most ranks a CTA sums at once
constexpr int kTile = 256;            // K7b scalar path: columns per CTA (threads)
constexpr int kRowTile = 16;          // K7b scalar path: rows per CTA
constexpr int kMaxRank = 128;
constexpr int kAxpyThreads = 128;     // K7b rows path: most threads a CTA
constexpr int kAxpyRows = 8;          // K7b rows path: rows a CTA

// K7b rows path, by accumulator type: the columns a thread owns (one
// 16-byte access a row: 4 f32 or 8 bf16) and the rows it has in flight
template <typename Acc>
struct AxpyGeom {
  static constexpr int cols = 16 / sizeof(Acc);
  static constexpr int unroll = sizeof(Acc) == 4 ? 8 : 4;
};

template <int RC>
__global__ void __launch_bounds__(kWarps * 32)
lowrank_project_kernel(const float* __restrict__ m, const float* __restrict__ v,
                       float* __restrict__ p, int rows, int n, int r,
                       long long v_bstride) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row0 = warp * kRowsPerWarp;
  if (row0 >= rows) return;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * RC;
  const float* mb = m + static_cast<size_t>(b) * rows * n;
  const float* vb = v + static_cast<size_t>(b) * v_bstride;
  float s[kRowsPerWarp][RC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) s[i][c] = 0.0f;
  const int groups = (n + 31) / 32;
#pragma unroll 4
  for (int k = 0; k < groups; ++k) {
    const int j = k * 32 + lane;
    const bool in = j < n;
    float vv[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c)
      vv[c] = in && c0 + c < r ? __ldg(vb + static_cast<size_t>(j) * r + c0 + c) : 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float x = in && row0 + i < rows ? mb[static_cast<size_t>(row0 + i) * n + j] : 0.0f;
#pragma unroll
      for (int c = 0; c < RC; ++c) s[i][c] = __fadd_rn(s[i][c], __fmul_rn(x, vv[c]));
    }
  }
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < RC; ++c)
        s[i][c] = __fadd_rn(s[i][c], __shfl_down_sync(0xFFFFFFFFu, s[i][c], h));
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (row0 + i >= rows) break;
      float* out = p + (static_cast<size_t>(b) * rows + row0 + i) * r + c0;
#pragma unroll
      for (int c = 0; c < RC; ++c)
        if (c0 + c < r) out[c] = s[i][c];
    }
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kTile)
lowrank_axpy_kernel(const float* __restrict__ p, const float* __restrict__ v,
                    const Acc* acc, Acc* out, int rows, int n, int r,
                    long long v_bstride, float aw, float w) {
  extern __shared__ float sv[];                  // [r][kTile], column t private to thread t
  const int t = threadIdx.x;
  const int j = blockIdx.x * kTile + t;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRowTile;
  if (j >= n) return;
  const float* vb = v + static_cast<size_t>(b) * v_bstride + static_cast<size_t>(j) * r;
  for (int c = 0; c < r; ++c) sv[c * kTile + t] = __ldg(vb + c);
  const float* pb = p + static_cast<size_t>(b) * rows * r;
  const int i1 = min(i0 + kRowTile, rows);
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const float* pr = pb + static_cast<size_t>(i) * r;
    float dot = __fmul_rn(__ldg(pr), sv[t]);
    for (int c = 1; c < r; ++c) dot = __fadd_rn(dot, __fmul_rn(__ldg(pr + c), sv[c * kTile + t]));
    const size_t e = (static_cast<size_t>(b) * rows + i) * n + j;
    accum::store(out, e, __fadd_rn(__fmul_rn(aw, accum::load(acc, e)), __fmul_rn(w, dot)));
  }
}

// The rows path of K7b at rank R: thread t owns columns j..j+C-1 of the
// CTA's tile and rows [i0, i1) of batch b.
template <typename Acc, int R>
__global__ void __launch_bounds__(kAxpyThreads)
lowrank_axpy_rows_kernel(const float* __restrict__ p, const float* __restrict__ v,
                         const Acc* acc, Acc* out, int rows, int n, long long v_bstride,
                         float aw, float w) {
  __shared__ float sp[kAxpyRows * R];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kAxpyRows;
  const int i1 = min(i0 + kAxpyRows, rows);
  const float* pb = p + (static_cast<size_t>(b) * rows + i0) * R;
  for (int t = threadIdx.x; t < (i1 - i0) * R; t += blockDim.x) sp[t] = __ldg(pb + t);
  __syncthreads();
  constexpr int C = AxpyGeom<Acc>::cols, U = AxpyGeom<Acc>::unroll;
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * C;
  if (j >= n) return;
  float vv[C][R];
  const float* vb = v + static_cast<size_t>(b) * v_bstride + static_cast<size_t>(j) * R;
#pragma unroll
  for (int e = 0; e < C; ++e)
#pragma unroll
    for (int c = 0; c < R; ++c) vv[e][c] = __ldg(vb + e * R + c);
  const size_t base = static_cast<size_t>(b) * rows * n + j;
  for (int i = i0; i < i1; i += U) {
    accum::Vec<Acc, C> a[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      a[u] = accum::load_vec<C>(acc, base + static_cast<size_t>(min(i + u, i1 - 1)) * n, true);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u >= i1) break;
      float pr[R];
#pragma unroll
      for (int c = 0; c < R; ++c) pr[c] = sp[(i + u - i0) * R + c];
      float o[C];
#pragma unroll
      for (int e = 0; e < C; ++e) {
        float dot = __fmul_rn(pr[0], vv[e][0]);
#pragma unroll
        for (int c = 1; c < R; ++c) dot = __fadd_rn(dot, __fmul_rn(pr[c], vv[e][c]));
        o[e] = __fadd_rn(__fmul_rn(aw, a[u].get(e)), __fmul_rn(w, dot));
      }
      accum::store_vec<C>(out, base + static_cast<size_t>(i + u) * n, o, true);
    }
  }
}

template <int RC>
int launch_project(const float* m, const float* v, float* p, int batch, int rows, int n,
                   int r, long long v_bstride, cudaStream_t stream) {
  const int rows_per_cta = kWarps * kRowsPerWarp;
  const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, batch, (r + RC - 1) / RC);
  lowrank_project_kernel<RC><<<grid, kWarps * 32, 0, stream>>>(m, v, p, rows, n, r,
                                                              v_bstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename Acc, int R>
int launch_axpy_rows(const float* p, const float* v, const Acc* acc, Acc* out, int batch,
                     int rows, int n, long long v_bstride, float aw, float w,
                     cudaStream_t stream) {
  const int col_threads = n / AxpyGeom<Acc>::cols;
  const int threads = std::min(kAxpyThreads, (col_threads + 31) / 32 * 32);
  const int row_tiles = (rows + kAxpyRows - 1) / kAxpyRows;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((col_threads + threads - 1) / threads, row_tiles, batch);
  lowrank_axpy_rows_kernel<Acc, R><<<grid, threads, 0, stream>>>(p, v, acc, out, rows, n,
                                                                 v_bstride, aw, w);
  return static_cast<int>(cudaGetLastError());
}

// K7b takes the rows path at ranks 1, 2 and 4 with a 16-byte aligned acc and
// out and rows whose tiles fit one grid dimension, else the scalar path.
bool axpy_rows_path(int r, int rows, const void* acc, const void* out) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  return vec && (r == 1 || r == 2 || r == 4) && (rows + kAxpyRows - 1) / kAxpyRows <= 65535;
}

template <typename Acc>
int launch_axpy(const void* p, const void* v, const void* acc, void* out, int batch, int rows,
                int n, int r, long long v_bstride, float aw, float w, void* stream) {
  if (batch == 0 || rows == 0) return 0;
  if (r < 1 || r > kMaxRank || n % 128 != 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pf = static_cast<const float*>(p);
  const auto* vf = static_cast<const float*>(v);
  const auto* a = static_cast<const Acc*>(acc);
  auto* o = static_cast<Acc*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (axpy_rows_path(r, rows, acc, out)) {
    if (r == 1)
      return launch_axpy_rows<Acc, 1>(pf, vf, a, o, batch, rows, n, v_bstride, aw, w, s);
    if (r == 2)
      return launch_axpy_rows<Acc, 2>(pf, vf, a, o, batch, rows, n, v_bstride, aw, w, s);
    return launch_axpy_rows<Acc, 4>(pf, vf, a, o, batch, rows, n, v_bstride, aw, w, s);
  }
  const int smem = r * kTile * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lowrank_axpy_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int row_tiles = (rows + kRowTile - 1) / kRowTile;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTile - 1) / kTile, row_tiles, batch);
  lowrank_axpy_kernel<Acc><<<grid, kTile, smem, s>>>(pf, vf, a, o, rows, n, r, v_bstride, aw, w);
  return static_cast<int>(cudaGetLastError());
}

// Every K7b kernel instance, for `lowrank_kernel_attrs`
struct KernelEntry {
  const char* name;
  const void* fn;
};
const KernelEntry kAxpyKernels[] = {
    {"lowrank_axpy_rows_kernel<float, 1>",
     reinterpret_cast<const void*>(lowrank_axpy_rows_kernel<float, 1>)},
    {"lowrank_axpy_rows_kernel<float, 2>",
     reinterpret_cast<const void*>(lowrank_axpy_rows_kernel<float, 2>)},
    {"lowrank_axpy_rows_kernel<float, 4>",
     reinterpret_cast<const void*>(lowrank_axpy_rows_kernel<float, 4>)},
    {"lowrank_axpy_rows_kernel<bf16, 1>",
     reinterpret_cast<const void*>(lowrank_axpy_rows_kernel<__nv_bfloat16, 1>)},
    {"lowrank_axpy_rows_kernel<bf16, 2>",
     reinterpret_cast<const void*>(lowrank_axpy_rows_kernel<__nv_bfloat16, 2>)},
    {"lowrank_axpy_rows_kernel<bf16, 4>",
     reinterpret_cast<const void*>(lowrank_axpy_rows_kernel<__nv_bfloat16, 4>)},
    {"lowrank_axpy_kernel<float>", reinterpret_cast<const void*>(lowrank_axpy_kernel<float>)},
    {"lowrank_axpy_kernel<bf16>",
     reinterpret_cast<const void*>(lowrank_axpy_kernel<__nv_bfloat16>)},
};

}  // namespace

// Plain C interface, bound with ctypes (kernels/build.py).  Each returns the
// cudaGetLastError() after its launch: 0 when the launch was accepted.
// Preconditions, checked by the Python wrappers: 1 <= r <= 128, batch <=
// 65535, M, P, acc and out contiguous (batch, rows, ·) buffers, V contiguous
// (n, r) slices at batch stride v_bstride (0 or n*r), one device; for K7b
// n % 128 == 0.
extern "C" int lowrank_project_2d_launch(const void* m, const void* v, void* p, int batch,
                                         int rows, int n, int r, long long v_bstride,
                                         void* stream) {
  if (batch == 0 || rows == 0) return 0;
  if (r < 1 || r > kMaxRank || n < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* mf = static_cast<const float*>(m);
  const auto* vf = static_cast<const float*>(v);
  auto* pf = static_cast<float*>(p);
  auto s = static_cast<cudaStream_t>(stream);
  if (r == 1) return launch_project<1>(mf, vf, pf, batch, rows, n, r, v_bstride, s);
  if (r == 2) return launch_project<2>(mf, vf, pf, batch, rows, n, r, v_bstride, s);
  if (r <= 4) return launch_project<4>(mf, vf, pf, batch, rows, n, r, v_bstride, s);
  return launch_project<kRankChunk>(mf, vf, pf, batch, rows, n, r, v_bstride, s);
}

extern "C" int lowrank_axpy_2d_launch(const void* p, const void* v, const void* acc,
                                      void* out, int batch, int rows, int n, int r,
                                      long long v_bstride, float aw, float w, void* stream) {
  return launch_axpy<float>(p, v, acc, out, batch, rows, n, r, v_bstride, aw, w, stream);
}

// K7b with a bfloat16 accumulator (accum.cuh): the same arithmetic in f32
extern "C" int lowrank_axpy_2d_bf16_launch(const void* p, const void* v, const void* acc,
                                           void* out, int batch, int rows, int n, int r,
                                           long long v_bstride, float aw, float w,
                                           void* stream) {
  return launch_axpy<__nv_bfloat16>(p, v, acc, out, batch, rows, n, r, v_bstride, aw, w,
                                    stream);
}

// The path K7b takes at rank r and rows a slab with acc and out at these
// addresses, without launching: 1 the rows path, 0 the scalar path.
extern "C" int lowrank_axpy_2d_path(int r, int rows, const void* acc, const void* out) {
  return axpy_rows_path(r, rows, acc, out) ? 1 : 0;
}

// Registers and local (spill) bytes of K7b's kernel instance i, from
// cudaFuncGetAttributes, and its name (at most len - 1 characters): 0, a
// CUDA error, or -1 past the last instance.
extern "C" int lowrank_kernel_attrs(int i, int* regs, int* local_bytes, char* name, int len) {
  if (i < 0 || i >= static_cast<int>(sizeof(kAxpyKernels) / sizeof(kAxpyKernels[0]))) return -1;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kAxpyKernels[i].fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  std::strncpy(name, kAxpyKernels[i].name, len - 1);
  name[len - 1] = '\0';
  return 0;
}

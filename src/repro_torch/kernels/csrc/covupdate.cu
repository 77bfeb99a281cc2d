// Rank-1 iteration updates for Hopper (sm_90a): paper Algorithms 7 and 8,
// Eq. (10)/(11). One kernel, three modes of one design.
//
// (a) TPU-kernel mode replaces the TPU kernels of
//     src/repro/kernels/covupdate.py, one dataset (p, n), b given:
//
//   update_data (`_update_data_kernel`, :21; call :56):
//     out[i, k] = (x[i, k] - b[i] * x_root[k]) * inv[i]
//   update_cov (`_update_cov_kernel`, :29; call :86):
//     out[i, j] = (c[i, j] - b[i] * b[j]) * inv[i] * inv[j], 1 on the diagonal
//   with inv = 1 / sqrt(max(1 - b^2, 1e-12)): no clip, no renormalization.
//
// (b) Fit mode is the scan's whole per-iteration update, what
//     src/repro/core/covariance.py:87-141 (`rank1_gates`, `update_data`,
//     `update_cov`; called at src/repro/core/paralingam.py:530-531 and
//     :634-635) computes, over a bucket (B, m, n) with one root, live-row
//     mask and valid count per dataset, in ONE launch for the whole bucket:
//
//     live_i = mask[i] && i != root;  b_i = live_i ? clip(c[i, root], -1, 1) : 0
//     s_i    = sqrt(max(1 - b_i^2, 1e-4))
//     out_i  = (x_i - b_i * x_root) / s_i,  then for a live row
//              out_i * rsqrt(max(sum_k<n_valid out_ik^2 / max(n_valid - 1, 1), 1e-12))
//     c'_ij  = clip((c_ij - b_i b_j) / (s_i s_j), -1, 1), 1 on the diagonal.
//
// (c) Ring mode is the same update on one rank's block of the messaging ring
//     (src/repro_torch/dist/ring_order.py, `_update_shard`): rows
//     [row0, row0 + m_l) of x (m_l, n_loc: this rank's sample shard) and of
//     c (m_l, m), with the root's data row and the gates b, s of the own rows
//     and of every column given (the root row lives on another rank; the
//     gates come from the root column gathered over every row block). Its
//     sums of squares are this shard's; where the samples are sharded they
//     are summed across the sample shards between two launches: the first
//     writes each row's sum and c', the second scales the rows from the
//     summed sums (recomputing x - b x_root, which costs one read of x less
//     than keeping it). With the samples whole one launch does both, as in
//     fit mode. The variance divides by the global n - 1. c' may be written
//     over c (no block reads another's entries: the gates are given).
//
// Rounding: every product, difference and quotient is rounded on its own
// (__fmul_rn, __fsub_rn, __fdiv_rn, __fadd_rn: no FMA contraction), in the
// order of the plain torch expressions; sqrtf is the correctly rounded square
// root, as torch's sqrt; rsqrtf is what torch's CUDA rsqrt calls (the same
// bits: `[rank1_scale_probe]`); a division by a Python number is torch's
// `a * (1 / b)`. The one sum, the variance's sum of squares, is taken in
// float32 in the order of torch.sum over a contiguous (B * m, n) tensor
// (ATen's reduce kernel, Reduce.cuh): the same block shape (bw x bh threads
// from the row count and n), the same 16-byte vectors from the same offset
// (rows of torch's freshly allocated square start at (row * n) % 4 floats
// past an aligned address), four accumulators per thread, the head and tail
// elements, the per-thread combine, the shared-memory and warp-shuffle trees
// over x, the tree over y, and the split across blocks for very long rows.
// The squares are staged in shared memory and each of torch's threads is
// replayed in its own order (`TorchSum`, `torch_row_sum`). So x' and c' are
// bit-equal to the plain version (`[rank1_update_vs_plain]`,
// `[rank1_sum_order]`), and a dataset's result depends on its batch exactly
// as the plain version's does: only through torch's block shape, which is
// the same for every row count of 16 or more.
//
// What bounds it on the card: memory, and below a few microseconds the
// launch. Each data element is read once and written once with ~7 FP32
// operations (the division is IEEE, as torch's); the live bytes of the first
// update of an E. coli dispatch (B=8, 630 live rows of 8,197-9,904 valid
// samples) are ~48 MB, ~14 us at 3.35 TB/s, and of one p=85, n=10000 fit
// iteration ~6.9 MB, ~2 us; an empty kernel on the same grid takes ~1-1.5
// us. The design is about bytes in flight and about moving no byte that is
// not live:
//
// - the grid: blocks [0, data_blocks) do data, the rest correlation tiles.
//   Fit mode gives one 256-thread block to each (dataset, row); TPU mode one
//   to each (row, 2,048-column segment); a correlation tile is <= 2,048
//   entries of one dataset's rows, with b and s (TPU mode: b and inv) of
//   its columns and rows computed once per block into shared memory, not
//   once per element, while its entries load (1,024-column segments and
//   tiles sized for ~256 blocks measured no faster at p=512);
// - 16-byte loads and stores where rows are 16-byte aligned (n, resp. m, a
//   multiple of 4 and aligned base pointers), a scalar path over the same
//   columns otherwise;
// - a fit-mode data row keeps up to 12 float4 of its result per thread in
//   registers and their squares in shared memory (rows up to 12,288 valid
//   columns), so it is read once, summed, scaled and written once; longer
//   rows recompute their columns past that from x and x_root. All loads of
//   a thread are issued before the first use;
// - each row stops at its dataset's valid count; dead rows (the root
//   included) and so dead datasets cost nothing in place;
// - the replay of torch.sum costs a staging of the squares, three barriers
//   and, where torch gives a row one warp (n < 8,161), a lane's chain of
//   n / 128 dependent adds. A one-dataset fit has a row per block and fewer
//   rows than SMs: latency, not bandwidth, sets its time.
//
// In-place choices (fit mode): every correlation block reads column `root`
// of c, so c' is always a second buffer (x_out == x is allowed, c_out == c
// is not); and c' is written in full, dead entries included, so it stays
// bit-equal to the plain version. x' may be written over x: a live row is
// read and written by its own block only, the root row is dead and never
// written, so x_root is read safely. In place, dead rows and columns at or
// past the valid count are not touched (the caller's padding is zero, and
// so is the plain version's there). Out of place, dead rows are copied and
// columns past the valid count are written as +0. A dead row keeps its bits
// where the plain version computes (x - 0 * x_root) / 1: they differ only
// at a -0 entry (plain gives +0 where x_root < 0) or a non-finite x_root.
//
// Contract (see covupdate.py): float32 contiguous x and c, uint8/bool mask,
// int64 roots in [0, m), int32 valid counts <= n or none; batch, m, n >= 1.
// A row that torch would sum in more than kMaxCtas blocks (n of ~2.7e8) is
// refused with cudaErrorNotSupported. Launches on the given stream, does not
// synchronize, allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVecs = 12;                       // fit mode: float4 per thread in registers
constexpr int kRowCols = 4 * kThreads * kRowVecs;  // 12,288 columns held in registers
constexpr int kSegVecs = 2;                        // TPU mode: float4 per thread per segment
constexpr int kSegCols = 4 * kThreads * kSegVecs;  // 2,048 columns per data block
constexpr int kTileElems = 8 * kThreads;           // 2,048 entries per correlation tile
constexpr int kColChunk = 2048;                    // columns of a correlation tile
constexpr int kTileRows = 64;                      // rows of a correlation tile at most
constexpr float kVarEps = 1e-12f;                  // covariance.VAR_EPS
constexpr float kFloor = 1e-4f;                    // covariance.COLLINEAR_FLOOR
constexpr int kTorchThreads = 512;                 // ATen reduce: most threads in a block
constexpr int kMaxCtas = 2048;                     // blocks per row of torch.sum replayed at most

enum Mode { kModeData = 0, kModeCov = 1, kModeFit = 2, kModeRing = 3 };
// Ring mode's launches: sums and scale in one (samples whole), the sums and
// c' (before the sums are added across sample shards), the scale.
enum RingPhase { kRingFused = 0, kRingSums = 1, kRingScale = 2 };
// The kernel's kinds: TPU mode, fit mode, ring mode.
enum Kind { kTpu = 0, kFit = 1, kRing = 2 };

// How torch.sum reduces a contiguous (rows, n) float32 tensor over its last
// dimension (ATen's setReduceConfig, sum of floats: 4 accumulators, vectors
// of 4): a block of bw x bh threads; `split` when the bh warps share one row
// (else each warp sums a row of its own); `ctas` blocks per row when a row
// is split across blocks (its partials added by the last one).
struct TorchSum {
  int vec;      // 16-byte vectors (n >= 128)
  int bw, bh;
  int split;
  int ctas;
  int threads;  // threads of one block summing one row
};

struct Args {
  const float* x;         // (B, m, n)
  float* x_out;           // (B, m, n), may be x (fit mode)
  const float* c;         // (B, m, m)
  float* c_out;           // (B, m, m), never c
  const float* b;         // TPU mode: (m,) coefficients
  const float* x_root;    // TPU mode: (n,) the root's row
  const long long* roots; // fit mode: (B,)
  const unsigned char* mask;  // fit mode: (B, m) live rows
  const int* n_valid;     // fit mode: (B,) or null
  const float* g_b;       // ring mode: (m_l,) b of the own rows
  const float* g_s;       // ring mode: (m_l,) s of the own rows
  const float* g_bc;      // ring mode: (m,) b of every column
  const float* g_sc;      // ring mode: (m,) s of every column
  const unsigned char* live;  // ring mode: (m_l,) own rows live (the root dead)
  float* sq;              // ring mode: (m_l,) each row's sum of squares
  int phase;              // ring mode: kRingFused, kRingSums or kRingScale
  int rows, row0;         // correlation rows per dataset and the global id of the first
  float inv_den;          // fit mode without n_valid, ring mode: 1 / (n - 1), as torch rounds it
  TorchSum order;         // fit mode: torch.sum's order over (B * m, n)
  int sq_cap;             // fit mode: squares staged in shared memory per row
  int m, n;
  int data_blocks, segs;  // data role: blocks, segments per row (TPU mode)
  int tile_rows, row_groups, col_chunks;  // correlation role, per dataset
};

struct Plan {
  int data_blocks = 0, segs = 1, tile_rows = 1, row_groups = 0, col_chunks = 0,
      cov_blocks = 0;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// `rows`: the correlation rows of a dataset (ring mode's m_l; m otherwise).
// Ring mode with `cov` false is its scale launch: data blocks only.
Plan plan_of(int mode, int batch, int m, int n, int rows, bool cov = true) {
  Plan p;
  if (mode != kModeCov) {
    p.segs = mode == kModeData ? ceil_div(n, kSegCols) : 1;
    p.data_blocks = batch * rows * p.segs;
  }
  if (mode != kModeData && cov) {
    const int w = m < kColChunk ? m : kColChunk;
    const int tr = kTileElems / w;
    p.tile_rows = tr < 1 ? 1 : (tr > kTileRows ? kTileRows : tr);
    p.row_groups = ceil_div(rows, p.tile_rows);
    p.col_chunks = ceil_div(m, kColChunk);
    p.cov_blocks = batch * p.row_groups * p.col_chunks;
  }
  return p;
}

// torch.clamp: a NaN passes through.
__device__ __forceinline__ float floor_at(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clip1(float v) {
  v = v < -1.f ? -1.f : v;
  return v > 1.f ? 1.f : v;
}

// covariance.rank1_gates for one entry: (b, s).
__device__ __forceinline__ float2 gates(float b_raw, bool live) {
  const float b = live ? clip1(b_raw) : 0.f;
  return make_float2(b, sqrtf(floor_at(__fsub_rn(1.f, __fmul_rn(b, b)), kFloor)));
}

// TPU mode: (b, 1 / sqrt(max(1 - b^2, 1e-12))).
__device__ __forceinline__ float2 tpu_gates(float b) {
  return make_float2(b, __fdiv_rn(1.f, sqrtf(floor_at(__fsub_rn(1.f, __fmul_rn(b, b)), kVarEps))));
}

__device__ __forceinline__ float row_scale(float var) { return rsqrtf(floor_at(var, kVarEps)); }

// Columns k..k+3 of row p; in the scalar path columns at or past lim read 0.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int k, int lim) {
  if (kVec) return *reinterpret_cast<const float4*>(p + k);
  return make_float4(k < lim ? p[k] : 0.f, k + 1 < lim ? p[k + 1] : 0.f,
                     k + 2 < lim ? p[k + 2] : 0.f, k + 3 < lim ? p[k + 3] : 0.f);
}

// Columns k..k+3 into row p; the scalar path stores only columns below lim.
template <bool kVec>
__device__ __forceinline__ void store4(float* p, int k, int lim, float4 v) {
  if (kVec) {
    *reinterpret_cast<float4*>(p + k) = v;
    return;
  }
  if (k < lim) p[k] = v.x;
  if (k + 1 < lim) p[k + 1] = v.y;
  if (k + 2 < lim) p[k + 2] = v.z;
  if (k + 3 < lim) p[k + 3] = v.w;
}

// (x - b x_root) / s, +0 at or past the valid count.
__device__ __forceinline__ float fit_elem(float x, float r, float b, float s, bool valid) {
  return valid ? __fdiv_rn(__fsub_rn(x, __fmul_rn(b, r)), s) : 0.f;
}

__device__ __forceinline__ float4 fit4(float4 x, float4 r, float b, float s, int k, int nv) {
  return make_float4(fit_elem(x.x, r.x, b, s, k < nv), fit_elem(x.y, r.y, b, s, k + 1 < nv),
                     fit_elem(x.z, r.z, b, s, k + 2 < nv), fit_elem(x.w, r.w, b, s, k + 3 < nv));
}

// v * g, +0 at or past the valid count (also where g is NaN).
__device__ __forceinline__ float4 scale4(float4 v, float g, int k, int nv) {
  return make_float4(k < nv ? __fmul_rn(v.x, g) : 0.f, k + 1 < nv ? __fmul_rn(v.y, g) : 0.f,
                     k + 2 < nv ? __fmul_rn(v.z, g) : 0.f, k + 3 < nv ? __fmul_rn(v.w, g) : 0.f);
}

// One level of a tree over vals: in each group of `width` slots, slot x
// adds slot x + off where `take(x)`; then the block waits.
template <typename Take>
__device__ __forceinline__ void tree_level(float* vals, int groups, int width, int stride, int off,
                                           Take take) {
  for (int t = threadIdx.x; t < groups * width; t += kThreads) {
    const int g = t / width, x = t - g * width;
    if (take(x) && x + off < width) {
      vals[g * stride + x] = __fadd_rn(vals[g * stride + x], vals[g * stride + x + off]);
    }
  }
  __syncthreads();
}

// ATen's block_x_reduce on `groups` rows of bw values: the shared-memory
// levels while more than a warp is left, then the warp's shuffles down by
// 16, 8, .., 1 (ATen of torch 2.11; older ATen shuffled by 1, 2, .., 16,
// which `[rank1_sum_order]` would show as a mismatch). Each level adds
// slot x + off into slot x < off; the result of group g lands in
// vals[g * stride].
__device__ void torch_x_tree(float* vals, int groups, int bw, int stride) {
  for (int off = bw / 2; off > 0; off >>= 1) {
    const int width = off >= 32 ? bw : (bw < 32 ? bw : 32);
    tree_level(vals, groups, width, stride, off, [=](int x) { return x < off; });
  }
}

// ATen's block_y_reduce on the first `cols` columns of a bh x stride grid
// of values: column x's result lands in vals[x].
__device__ void torch_y_tree(float* vals, int bh, int stride, int cols) {
  for (int off = bh / 2; off > 0; off >>= 1) {
    for (int t = threadIdx.x; t < off * cols; t += kThreads) {
      const int y = t / cols, x = t - y * cols;
      vals[y * stride + x] = __fadd_rn(vals[y * stride + x], vals[(y + off) * stride + x]);
    }
    __syncthreads();
  }
}

// One thread of ATen's reduce summing a row of n floats: thread u of block
// (slice) c. sq(e) is element e (0 for e >= nv, which adds nothing), shift
// the row's offset in floats past a 16-byte boundary. Returns the thread's
// value after it combines its four accumulators.
template <typename Sq>
__device__ __forceinline__ float torch_thread_sum(const TorchSum& o, int u, int c, int n, int nv,
                                                  int shift, Sq sq) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int stride = o.threads * o.ctas;  // vectors (or elements) between its steps
  const int idx0 = u + c * o.threads;
  const bool edge = c == 0 && u < 4;  // head and tail: lanes x < 4 of warp 0 of block 0
  if (o.vec) {
    const int e0 = (4 - shift) & 3;  // the head: elements before the first vector
    const int len = n - e0;
    if (edge && shift > 0 && u >= shift) acc[0] = sq(u - shift);
    for (int v = idx0; 4 * v + 3 < len; v += stride) {
      const int e = e0 + 4 * v;
      if (e >= nv) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], sq(e + i));
    }
    const int tail = len - len % 4;
    if (edge && u < len % 4) acc[0] = __fadd_rn(acc[0], sq(e0 + tail + u));
  } else {
    for (int j = 0, e = idx0; e < n && e < nv; ++j, e += stride) {
      acc[j & 3] = __fadd_rn(acc[j & 3], sq(e));
    }
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// torch.sum of one row in ATen's order (see torch_thread_sum). vals holds
// kTorchThreads floats and parts o.ctas more. Every thread returns the sum.
template <typename Sq>
__device__ float torch_row_sum(const TorchSum& o, int n, int nv, int shift, Sq sq, float* vals,
                               float* parts) {
  const int lane = threadIdx.x % 32;
  if (o.bw == 32 && o.ctas == 1) {
    // Each warp here replays whole warps of ATen's block (lane = x) with its
    // shuffles; then warp 0 replays the tree over its bh warps.
    for (int u0 = threadIdx.x - lane; u0 < o.threads; u0 += kThreads) {
      float v = torch_thread_sum(o, u0 + lane, 0, n, nv, shift, sq);
      for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) vals[u0 / 32] = v;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int warps = o.threads / 32;
      float v = lane < warps ? vals[lane] : 0.f;
      for (int off = warps / 2; off > 0; off >>= 1) {
        const float other = __shfl_down_sync(0xffffffffu, v, off);
        if (lane < off) v = __fadd_rn(v, other);
      }
      if (lane == 0) vals[0] = v;
    }
  } else {
    for (int c = 0; c < o.ctas; ++c) {
      for (int u = threadIdx.x; u < o.threads; u += kThreads) {
        vals[u] = torch_thread_sum(o, u, c, n, nv, shift, sq);
      }
      __syncthreads();
      torch_x_tree(vals, o.split ? o.bh : 1, o.bw, o.bw);
      if (o.split) torch_y_tree(vals, o.bh, o.bw, 1);
      if (o.ctas > 1 && threadIdx.x == 0) parts[c] = vals[0];
      __syncthreads();
    }
    if (o.ctas > 1) {  // the last block: thread t adds parts t, t + threads, ..
      for (int t = threadIdx.x; t < o.threads; t += kThreads) {
        float acc = 0.f;
        for (int c = t; c < o.ctas; c += o.threads) acc = __fadd_rn(acc, parts[c]);
        vals[t] = acc;
      }
      __syncthreads();
      torch_y_tree(vals, o.bh, o.bw, o.bw);
      torch_x_tree(vals, 1, o.bw, o.bw);
    }
  }
  __syncthreads();
  const float total = vals[0];
  __syncthreads();  // vals may be written again
  return total;
}

template <bool kVec>
__device__ void copy_row(const float* src, float* dst, int n) {
  if (kVec) {
    for (int k = 4 * threadIdx.x; k < n; k += 4 * kThreads) store4<true>(dst, k, n, load4<true>(src, k, n));
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
  }
}

// Fit mode: one (dataset, row) per block. smem: the row's squares
// (a.sq_cap floats), then torch.sum's thread values and block partials.
template <bool kVec>
__device__ void fit_data_row(const Args& a, int row, float* smem) {
  const int d = row / a.m;
  const int i = row - d * a.m;
  const int root = static_cast<int>(a.roots[d]);
  const float* xrow = a.x + static_cast<size_t>(row) * a.n;
  float* orow = a.x_out + static_cast<size_t>(row) * a.n;
  const bool in_place = a.x_out == a.x;
  if (!a.mask[row] || i == root) {  // dead: unchanged (b = 0, s = 1, scale 1)
    if (!in_place) copy_row<kVec>(xrow, orow, a.n);
    return;
  }
  const float* xr = a.x + (static_cast<size_t>(d) * a.m + root) * a.n;
  const float2 bs = gates(a.c[static_cast<size_t>(row) * a.m + root], true);
  const int nv_raw = a.n_valid ? a.n_valid[d] : a.n;
  const int nv = nv_raw < 0 ? 0 : (nv_raw > a.n ? a.n : nv_raw);
  float* sq = smem;
  float* vals = smem + a.sq_cap;

  float4 v[kRowVecs];
#pragma unroll
  for (int t = 0; t < kRowVecs; ++t) {
    const int k = 4 * (threadIdx.x + t * kThreads);
    if (k < nv) v[t] = fit4(load4<kVec>(xrow, k, nv), load4<kVec>(xr, k, nv), bs.x, bs.y, k, nv);
  }
#pragma unroll
  for (int t = 0; t < kRowVecs; ++t) {  // torch.square, staged for the sum
    const int k = 4 * (threadIdx.x + t * kThreads);
    if (k < nv && k < a.sq_cap) {
      *reinterpret_cast<float4*>(sq + k) = make_float4(
          __fmul_rn(v[t].x, v[t].x), __fmul_rn(v[t].y, v[t].y), __fmul_rn(v[t].z, v[t].z),
          __fmul_rn(v[t].w, v[t].w));
    }
  }
  __syncthreads();
  const auto square = [&](int e) {
    if (e >= nv) return 0.f;
    if (e < a.sq_cap) return sq[e];
    const float o = fit_elem(xrow[e], xr[e], bs.x, bs.y, true);
    return __fmul_rn(o, o);
  };
  const int shift = static_cast<int>((static_cast<long long>(row) * a.n) & 3);
  const float sum = torch_row_sum(a.order, a.n, nv, shift, square, vals, vals + kTorchThreads);
  const float var = a.n_valid ? __fdiv_rn(sum, static_cast<float>(nv_raw - 1 > 1 ? nv_raw - 1 : 1))
                              : __fmul_rn(sum, a.inv_den);
  const float g = row_scale(var);
  // The vector path writes whole float4: columns of the last one past nv
  // get +0, which is what the caller's padding holds.
#pragma unroll
  for (int t = 0; t < kRowVecs; ++t) {
    const int k = 4 * (threadIdx.x + t * kThreads);
    if (k < nv) store4<kVec>(orow, k, nv, scale4(v[t], g, k, nv));
  }
  for (int k = kRowCols + 4 * threadIdx.x; k < nv; k += 4 * kThreads) {
    store4<kVec>(orow, k, nv, scale4(fit4(load4<kVec>(xrow, k, nv), load4<kVec>(xr, k, nv),
                                          bs.x, bs.y, k, nv), g, k, nv));
  }
  if (!in_place) {
    for (int k = (kVec ? 4 * ceil_div(nv, 4) : nv) + threadIdx.x; k < a.n; k += kThreads) orow[k] = 0.f;
  }
}

// Ring mode: one own row per block. smem as in fit mode. The sums launch
// writes each row's sum of squares (0 for a dead row); the scale launch
// reads them summed across the sample shards; the fused launch does both.
template <bool kVec>
__device__ void ring_data_row(const Args& a, int i, float* smem) {
  const float* xrow = a.x + static_cast<size_t>(i) * a.n;
  float* orow = a.x_out + static_cast<size_t>(i) * a.n;
  const bool in_place = a.x_out == a.x;
  const int n = a.n;
  if (!a.live[i]) {  // dead or the root: unchanged (b = 0, s = 1, scale 1)
    if (a.phase != kRingSums && !in_place) copy_row<kVec>(xrow, orow, n);
    if (a.phase != kRingScale && threadIdx.x == 0) a.sq[i] = 0.f;
    return;
  }
  const float b = a.g_b[i], s = a.g_s[i];
  const float* xr = a.x_root;
  if (a.phase == kRingScale) {
    const float g = row_scale(__fmul_rn(a.sq[i], a.inv_den));
    for (int k = 4 * threadIdx.x; k < n; k += 4 * kThreads) {
      store4<kVec>(orow, k, n, scale4(fit4(load4<kVec>(xrow, k, n), load4<kVec>(xr, k, n), b, s, k, n),
                                      g, k, n));
    }
    return;
  }
  float* sq = smem;
  float* vals = smem + a.sq_cap;
  float4 v[kRowVecs];
#pragma unroll
  for (int t = 0; t < kRowVecs; ++t) {
    const int k = 4 * (threadIdx.x + t * kThreads);
    if (k < n) v[t] = fit4(load4<kVec>(xrow, k, n), load4<kVec>(xr, k, n), b, s, k, n);
  }
#pragma unroll
  for (int t = 0; t < kRowVecs; ++t) {  // torch.square, staged for the sum
    const int k = 4 * (threadIdx.x + t * kThreads);
    if (k < n && k < a.sq_cap) {
      *reinterpret_cast<float4*>(sq + k) = make_float4(
          __fmul_rn(v[t].x, v[t].x), __fmul_rn(v[t].y, v[t].y), __fmul_rn(v[t].z, v[t].z),
          __fmul_rn(v[t].w, v[t].w));
    }
  }
  __syncthreads();
  const auto square = [&](int e) {
    if (e < a.sq_cap) return sq[e];
    const float o = fit_elem(xrow[e], xr[e], b, s, true);
    return __fmul_rn(o, o);
  };
  const int shift = static_cast<int>((static_cast<long long>(i) * n) & 3);
  const float sum = torch_row_sum(a.order, n, n, shift, square, vals, vals + kTorchThreads);
  if (threadIdx.x == 0) a.sq[i] = sum;
  if (a.phase == kRingSums) return;
  const float g = row_scale(__fmul_rn(sum, a.inv_den));
#pragma unroll
  for (int t = 0; t < kRowVecs; ++t) {
    const int k = 4 * (threadIdx.x + t * kThreads);
    if (k < n) store4<kVec>(orow, k, n, scale4(v[t], g, k, n));
  }
  for (int k = kRowCols + 4 * threadIdx.x; k < n; k += 4 * kThreads) {
    store4<kVec>(orow, k, n, scale4(fit4(load4<kVec>(xrow, k, n), load4<kVec>(xr, k, n), b, s, k, n),
                                    g, k, n));
  }
}

// TPU mode: one (row, 2,048-column segment) per block.
template <bool kVec>
__device__ void tpu_data_segment(const Args& a, int blk) {
  const int i = blk / a.segs;
  const int k0 = (blk - i * a.segs) * kSegCols;
  const int k1 = a.n < k0 + kSegCols ? a.n : k0 + kSegCols;
  const float2 bi = tpu_gates(a.b[i]);
  const float* xrow = a.x + static_cast<size_t>(i) * a.n;
  float* orow = a.x_out + static_cast<size_t>(i) * a.n;
  float4 xv[kSegVecs], rv[kSegVecs];
#pragma unroll
  for (int t = 0; t < kSegVecs; ++t) {
    const int k = k0 + 4 * (threadIdx.x + t * kThreads);
    if (k < k1) {
      xv[t] = load4<kVec>(xrow, k, k1);
      rv[t] = load4<kVec>(a.x_root, k, k1);
    }
  }
#pragma unroll
  for (int t = 0; t < kSegVecs; ++t) {
    const int k = k0 + 4 * (threadIdx.x + t * kThreads);
    if (k < k1) {
      const float4 x = xv[t], r = rv[t];
      store4<kVec>(orow, k, k1, make_float4(
          __fmul_rn(__fsub_rn(x.x, __fmul_rn(bi.x, r.x)), bi.y),
          __fmul_rn(__fsub_rn(x.y, __fmul_rn(bi.x, r.y)), bi.y),
          __fmul_rn(__fsub_rn(x.z, __fmul_rn(bi.x, r.z)), bi.y),
          __fmul_rn(__fsub_rn(x.w, __fmul_rn(bi.x, r.w)), bi.y)));
    }
  }
}

// One correlation entry from the row's and the column's gates.
// (fit and ring modes: the clipped quotient; TPU mode: the product by inv).
template <bool kClip>
__device__ __forceinline__ float cov_elem(float c, float2 gi, float2 gj, bool diag) {
  if (diag) return 1.f;
  const float d = __fsub_rn(c, __fmul_rn(gi.x, gj.x));
  return kClip ? clip1(__fdiv_rn(d, __fmul_rn(gi.y, gj.y))) : __fmul_rn(__fmul_rn(d, gi.y), gj.y);
}

// A tile of <= kTileElems entries: rows [i0, i0 + h) x columns [j0, j0 + w)
// of one dataset's a.rows x m block (its row i is global row a.row0 + i).
// Its entries are loaded before the gates are computed, so the two memory
// latencies overlap.
template <int kKind, bool kVec>
__device__ void cov_tile(const Args& a, int blk, float2* col_g, float2* row_g) {
  constexpr bool kFitMode = kKind == kFit;
  const int per = a.row_groups * a.col_chunks;
  const int d = blk / per;
  const int g = (blk - d * per) / a.col_chunks;
  const int j0 = (blk - d * per - g * a.col_chunks) * kColChunk;
  const int i0 = g * a.tile_rows;
  const int m = a.m;
  const int w = m - j0 < kColChunk ? m - j0 : kColChunk;
  const int h = a.rows - i0 < a.tile_rows ? a.rows - i0 : a.tile_rows;
  const float* cd = a.c + static_cast<size_t>(d) * a.rows * m;
  float* od = a.c_out + static_cast<size_t>(d) * a.rows * m;
  // entry e of the tile: float4 e of a row of w / 4 (vector path), else a float
  const int wq = kVec ? w / 4 : w;
  constexpr int kPer = kVec ? kTileElems / 4 / kThreads : kTileElems / kThreads;
  float4 cv[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = threadIdx.x + t * kThreads;
    if (e < h * wq) {
      const int r = e / wq, q = e - r * wq;
      const float* row = cd + static_cast<size_t>(i0 + r) * m + j0;
      cv[t] = kVec ? load4<true>(row, 4 * q, w) : make_float4(row[q], 0.f, 0.f, 0.f);
    }
  }
  const int root = kFitMode ? static_cast<int>(a.roots[d]) : 0;
  const unsigned char* live = kFitMode ? a.mask + static_cast<size_t>(d) * m : nullptr;
  for (int t = threadIdx.x; t < w + h; t += kThreads) {
    const int idx = t < w ? j0 + t : i0 + t - w;
    float2 v;
    if (kKind == kRing) {
      v = t < w ? make_float2(a.g_bc[idx], a.g_sc[idx]) : make_float2(a.g_b[idx], a.g_s[idx]);
    } else {
      v = kFitMode ? gates(cd[static_cast<size_t>(idx) * m + root], live[idx] && idx != root)
                   : tpu_gates(a.b[idx]);
    }
    if (t < w) col_g[t] = v;
    else row_g[t - w] = v;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = threadIdx.x + t * kThreads;
    if (e < h * wq) {
      const int r = e / wq, q = e - r * wq;
      const int i = i0 + r;
      const int gid = a.row0 + i;  // the row's global id, for the diagonal
      const float2 gi = row_g[r];
      float* row = od + static_cast<size_t>(i) * m + j0;
      constexpr bool kClip = kKind != kTpu;
      if (kVec) {
        const int j = j0 + 4 * q;
        store4<true>(row, 4 * q, w, make_float4(
            cov_elem<kClip>(cv[t].x, gi, col_g[4 * q], gid == j),
            cov_elem<kClip>(cv[t].y, gi, col_g[4 * q + 1], gid == j + 1),
            cov_elem<kClip>(cv[t].z, gi, col_g[4 * q + 2], gid == j + 2),
            cov_elem<kClip>(cv[t].w, gi, col_g[4 * q + 3], gid == j + 3)));
      } else {
        row[q] = cov_elem<kClip>(cv[t].x, gi, col_g[q], gid == j0 + q);
      }
    }
  }
}

template <int kKind, bool kVecX, bool kVecC>
__global__ void __launch_bounds__(kThreads, 2) rank1_update_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int blk = blockIdx.x;
  if (blk < a.data_blocks) {
    if (kKind == kFit) fit_data_row<kVecX>(a, blk, reinterpret_cast<float*>(smem4));
    else if (kKind == kRing) ring_data_row<kVecX>(a, blk, reinterpret_cast<float*>(smem4));
    else tpu_data_segment<kVecX>(a, blk);
  } else {
    float2* col_g = reinterpret_cast<float2*>(smem4);
    cov_tile<kKind, kVecC>(a, blk - a.data_blocks, col_g,
                           col_g + (a.m < kColChunk ? a.m : kColChunk));
  }
}

__global__ void __launch_bounds__(kThreads, 2) rank1_update_empty() {}

// The scale of a row from its variance, for the check against torch.rsqrt.
__global__ void scale_probe(const float* __restrict__ var, float* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = row_scale(var[i]);
}

// torch.sum(x * x, -1) of a contiguous (rows, n) tensor, one row per block,
// in the order the fit mode replays: the check of that order.
__global__ void __launch_bounds__(kThreads) sum_probe(const float* __restrict__ x,
                                                    float* __restrict__ out, TorchSum o, int n) {
  extern __shared__ float4 smem4[];
  float* vals = reinterpret_cast<float*>(smem4);
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  const auto square = [&](int e) { return __fmul_rn(row[e], row[e]); };
  const int shift = static_cast<int>((static_cast<long long>(blockIdx.x) * n) & 3);
  const float sum = torch_row_sum(o, n, n, shift, square, vals, vals + kTorchThreads);
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int last_pow2(int v) {
  v |= v >> 1;
  v |= v >> 2;
  v |= v >> 4;
  v |= v >> 8;
  v |= v >> 16;
  const int p = v - (v >> 1);
  return p > 1 ? p : 1;
}

// ATen's setReduceConfig for a float sum over the last dimension of a
// contiguous (rows, n) float32 tensor (vt0 = input_vec_size = 4, at most
// 512 threads, 16 values per thread before the warps split a row, 256
// before the blocks do). False past kMaxCtas blocks per row.
bool torch_sum_of(int rows, int n, TorchSum* o) {
  o->vec = n >= 128;
  const int dim0 = o->vec ? n / 4 : n;
  const int dim0_pow2 = dim0 < kTorchThreads ? last_pow2(dim0) : kTorchThreads;
  const int dim1_pow2 = rows < kTorchThreads ? last_pow2(rows) : kTorchThreads;
  int bw = dim0_pow2 < 32 ? dim0_pow2 : 32;
  const int bh = dim1_pow2 < kTorchThreads / bw ? dim1_pow2 : kTorchThreads / bw;
  bw = dim0_pow2 < kTorchThreads / bh ? dim0_pow2 : kTorchThreads / bh;
  o->bw = bw;
  o->bh = bh;
  const int warp_split = bh * 16 < 256 ? bh * 16 : 256;
  o->split = ceil_div(n, bw) >= warp_split;
  o->threads = o->split ? bw * bh : bw;
  o->ctas = 1;
  const int per_thread = ceil_div(n, bw * bh);
  if (o->split && per_thread >= 256) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    const int target = sms * (per_sm / (bw * bh));
    if (rows <= target) {
      const int c1 = ceil_div(target, rows), c2 = ceil_div(per_thread, 16),
                c3 = ceil_div(per_thread, 256);
      const int lo = c1 < c2 ? c1 : c2;
      o->ctas = lo > c3 ? lo : c3;
    }
  }
  return o->ctas <= kMaxCtas;
}

constexpr int kFitSmemMax = (kRowCols + kTorchThreads + kMaxCtas) * 4;

template <int kKind>
int launch(const Args& a, int blocks, bool vec_x, bool vec_c, cudaStream_t st) {
  auto kernel = vec_x ? (vec_c ? rank1_update_kernel<kKind, true, true>
                               : rank1_update_kernel<kKind, true, false>)
                      : (vec_c ? rank1_update_kernel<kKind, false, true>
                               : rank1_update_kernel<kKind, false, false>);
  const int w = a.m < kColChunk ? a.m : kColChunk;
  int smem = a.row_groups ? (w + kTileRows) * 8 : 0;  // the correlation role's gates
  if (kKind != kTpu) {
    const int data = kKind == kRing && a.phase == kRingScale
                         ? 0 : (a.sq_cap + kTorchThreads + a.order.ctas) * 4;
    smem = smem > data ? smem : data;
    static bool raised[4] = {false, false, false, false};  // per kind; set twice at worst, harmlessly
    bool& done = raised[2 * vec_x + vec_c];
    if (!done) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFitSmemMax);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      done = true;
    }
  }
  kernel<<<blocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args args_of(const Plan& p, int m, int n, int rows) {
  Args a{};
  a.m = m;
  a.n = n;
  a.rows = rows;
  a.data_blocks = p.data_blocks;
  a.segs = p.segs;
  a.tile_rows = p.tile_rows;
  a.row_groups = p.row_groups;
  a.col_chunks = p.col_chunks;
  return a;
}

}  // namespace

extern "C" int update_data_launch(const void* x, const void* xr, const void* b,
                                  void* out, int p, int n, void* stream) {
  if (p < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_of(kModeData, 1, p, n, p);
  Args a = args_of(plan, p, n, p);
  a.x = static_cast<const float*>(x);
  a.x_root = static_cast<const float*>(xr);
  a.b = static_cast<const float*>(b);
  a.x_out = static_cast<float*>(out);
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(xr) && aligned16(out);
  return launch<kTpu>(a, plan.data_blocks, vec, false, static_cast<cudaStream_t>(stream));
}

extern "C" int update_cov_launch(const void* c, const void* b, void* out,
                                 int p, void* stream) {
  if (p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_of(kModeCov, 1, p, 1, p);
  Args a = args_of(plan, p, 1, p);
  a.c = static_cast<const float*>(c);
  a.b = static_cast<const float*>(b);
  a.c_out = static_cast<float*>(out);
  const bool vec = p % 4 == 0 && aligned16(c) && aligned16(out);
  return launch<kTpu>(a, plan.cov_blocks, false, vec, static_cast<cudaStream_t>(stream));
}

extern "C" int rank1_update_launch(const void* x, void* x_out, const void* c,
                                   void* c_out, const void* roots,
                                   const void* mask, const void* n_valid,
                                   int batch, int m, int n, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || c_out == c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = plan_of(kModeFit, batch, m, n, m);
  Args a = args_of(plan, m, n, m);
  a.x = static_cast<const float*>(x);
  a.x_out = static_cast<float*>(x_out);
  a.c = static_cast<const float*>(c);
  a.c_out = static_cast<float*>(c_out);
  a.roots = static_cast<const long long*>(roots);
  a.mask = static_cast<const unsigned char*>(mask);
  a.n_valid = static_cast<const int*>(n_valid);
  if (!torch_sum_of(batch * m, n, &a.order)) return static_cast<int>(cudaErrorNotSupported);
  // torch's CUDA division by a Python number: a * (1 / b), 1 / b in float
  a.inv_den = 1.f / static_cast<float>(n - 1 > 1 ? n - 1 : 1);
  a.sq_cap = 4 * ceil_div(n, 4) < kRowCols ? 4 * ceil_div(n, 4) : kRowCols;
  const bool vec_x = n % 4 == 0 && aligned16(x) && aligned16(x_out);
  const bool vec_c = m % 4 == 0 && aligned16(c) && aligned16(c_out);
  return launch<kFit>(a, plan.data_blocks + plan.cov_blocks, vec_x, vec_c,
                      static_cast<cudaStream_t>(stream));
}

// Ring mode, one launch of `phase` (see the top): x (m_l, n) and x_root (n,)
// this rank's sample shard, c (m_l, m) the rows [row0, row0 + m_l), the
// gates b, s (m_l,) and b_col, s_col (m,), live (m_l,) uint8, sq (m_l,) the
// sums (written by kRingFused and kRingSums, read by kRingScale), n_total
// the global sample count. x_out may be x, c_out may be c; kRingScale reads
// and writes x only.
extern "C" int ring_update_launch(const void* x, void* x_out, const void* c, void* c_out,
                                  const void* x_root, const void* b, const void* s,
                                  const void* b_col, const void* s_col, const void* live,
                                  void* sq, int phase, int m_l, int m, int n, int row0,
                                  int n_total, void* stream) {
  if (m_l < 1 || m < 1 || n < 1 || phase < kRingFused || phase > kRingScale || row0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = plan_of(kModeRing, 1, m, n, m_l, phase != kRingScale);
  Args a = args_of(plan, m, n, m_l);
  a.x = static_cast<const float*>(x);
  a.x_out = static_cast<float*>(x_out);
  a.c = static_cast<const float*>(c);
  a.c_out = static_cast<float*>(c_out);
  a.x_root = static_cast<const float*>(x_root);
  a.g_b = static_cast<const float*>(b);
  a.g_s = static_cast<const float*>(s);
  a.g_bc = static_cast<const float*>(b_col);
  a.g_sc = static_cast<const float*>(s_col);
  a.live = static_cast<const unsigned char*>(live);
  a.sq = static_cast<float*>(sq);
  a.phase = phase;
  a.row0 = row0;
  if (!torch_sum_of(m_l, n, &a.order)) return static_cast<int>(cudaErrorNotSupported);
  a.inv_den = 1.f / static_cast<float>(n_total - 1 > 1 ? n_total - 1 : 1);
  a.sq_cap = 4 * ceil_div(n, 4) < kRowCols ? 4 * ceil_div(n, 4) : kRowCols;
  const bool vec_x = n % 4 == 0 && aligned16(x) && aligned16(x_out) && aligned16(x_root);
  const bool vec_c = m % 4 == 0 && aligned16(c) && aligned16(c_out);
  return launch<kRing>(a, plan.data_blocks + plan.cov_blocks, vec_x, vec_c,
                       static_cast<cudaStream_t>(stream));
}

// The grid of a launch: mode 0 update_data (batch 1), 1 update_cov (batch
// 1, n ignored), 2 the fit mode, 3 ring mode's first launch (batch is m_l,
// its rows: m_l data blocks and the tiles of the (m_l, m) block).
extern "C" int rank1_update_blocks(int mode, int batch, int m, int n) {
  const Plan p = mode == kModeRing ? plan_of(mode, 1, m, n, batch) : plan_of(mode, batch, m, n, m);
  return p.data_blocks + p.cov_blocks;
}

// An empty kernel on the grid of a launch: the launch floor.
extern "C" int rank1_update_empty_launch(int mode, int batch, int m, int n, void* stream) {
  if (batch < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  rank1_update_empty<<<rank1_update_blocks(mode, batch, m, n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rank1_scale_probe(const void* var, void* out, int count, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  scale_probe<<<ceil_div(count, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(var), static_cast<float*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

// torch.sum(x * x, -1) of a contiguous (rows, n) float32 tensor in the order
// the fit mode replays (the check of that order against torch itself).
// ATen's block shape for it lands in shape[0..4]: bw, bh, split, ctas, vectors.
extern "C" int rank1_sum_probe(const void* x, void* out, int rows, int n, int* shape,
                               void* stream) {
  TorchSum o;
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!torch_sum_of(rows, n, &o)) return static_cast<int>(cudaErrorNotSupported);
  shape[0] = o.bw;
  shape[1] = o.bh;
  shape[2] = o.split;
  shape[3] = o.ctas;
  shape[4] = o.vec;
  const int smem = (kTorchThreads + o.ctas) * 4;  // <= 10 KB
  sum_probe<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), o, n);
  return static_cast<int>(cudaGetLastError());
}

// Rank-1 iteration updates for Hopper (sm_90a): paper Algorithms 7 and 8,
// Eq. (10)/(11). One source, three modes.
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
// Each of torch's threads is replayed, in its own order, on squares taken
// from rows staged in shared memory. So x' and c' are bit-equal to the plain
// version (`[rank1_update_vs_plain]`, `[rank1_sum_order]`), and a dataset's
// result depends on its batch exactly as the plain version's does: only
// through torch's block shape, which is the same for every row count of 16
// or more.
//
// What bounds the fit and ring modes on the card: memory, and below a few
// microseconds the launch and the latency of one row's load, sum and store.
// Each data element is read once and written once with ~7 FP32 operations
// (the division is IEEE, as torch's); the live bytes of the first update of
// an E. coli dispatch (B=8, 630 live rows of 8,197-9,904 valid samples) are
// ~48 MB, ~14 us at 3.35 TB/s, and of one p=85, n=10000 fit iteration ~6.9
// MB, ~2 us; an empty kernel on the same grid takes ~1-1.5 us. A one-dataset
// fit and a ring block have fewer rows (84, 63) than the card has SMs, so a
// design with a block per row leaves most SMs idle, and where torch gives a
// row one warp its block waits on that warp's chain of n / 128 adds. The
// data rows take one of three paths, chosen by the host (`plan_rows`, and
// `covupdate.update_plan` in Python, which mirrors it):
//
// - a row torch splits over its block's warps (bw = 32, 16 warps of 32
//   threads, u = x + 32 y, thread u summing vectors u, u + 512, ..) is
//   spread over a thread-block cluster of k = 1, 2 or 4 CTAs. CTA r replays
//   torch's threads [r * 512 / k, (r + 1) * 512 / k), so it needs exactly
//   the vectors of runs of 512 / k vectors at a stride of 512: warp 0 stages
//   those runs of x with 1-D bulk copies (`cp.async.bulk`, a run per lane,
//   completing on an mbarrier), every thread computes (x - b x_root) / s
//   once per element into the staged runs, the CTA replays its threads'
//   sums and warp shuffles from them and writes its warps' 16 / k partials
//   into the shared memory of every CTA of the cluster (distributed shared
//   memory). After one cluster barrier each CTA runs torch's tree over the
//   16 partials itself, in torch's order (each gets the same bits, so no CTA
//   waits for a leader to send the sum back), then scales and stores its
//   own runs. k is the least that puts k * rows >= 4 SMs' worth of CTAs in
//   flight with a CTA's staging <= 72 KB (three CTAs per SM), else 4: 4 at
//   the p=85 fit and a ring block of 64 rows, 1 at the E. coli dispatch's
//   1,024 rows; a 16,384-column row is held on chip whole (no second read);
// - where torch gives a row one warp (split false), a block holds R rows
//   of one dataset, each staged whole by a lane of warp 0: every thread
//   computes (x - b x_root) / s, warp w replays row w's 32 threads, so no
//   warp waits through another's chain, and every thread of the block then
//   scales and stores. R is the largest of 8, 4, 2, 1 that still gives as
//   many blocks as SMs (2 at the p=512 fit, 1 at a (1, 2, 2) ring block);
// - rows that are not 16-byte aligned (n not a multiple of 4: torch's
//   squares then start `shift` floats past a boundary; or a base pointer off
//   one), rows of fewer than 16 (torch's bw is then not 32), and rows too
//   long to hold on chip (torch splits them over several blocks past ~1.3e5
//   columns) take one CTA per row: staged whole when they fit (cp.async of
//   4 bytes per element in the scalar path), else read twice from global
//   memory, and summed by the general replay of torch's order.
//
// Departures, measured on the H100: x_root is read through the read-only
// cache (`__ldg`) and not staged. Every row of a dataset reads the same
// root row, which stays in L1 and L2; a staged copy per CTA doubled the
// shared memory and the copies, and dropping it took the dispatch's first
// update from 0.0299 to 0.0248 ms and the p=512 fit's from 0.0080 to 0.0065
// ms (the root row is dead in the launch, so no CTA writes what another
// reads this way). Every CTA of a cluster runs the final tree, on the same
// 16 values in the same order, which saves the barrier a send-back would
// need. The cluster path takes only 16-byte aligned rows, where torch's
// squares have no head or tail elements (n a multiple of 4 puts every
// row's shift at 0), so its runs need no edge vectors; unaligned rows keep
// one CTA per row. A persistent grid (clusters walking rows, the next row's
// copies in flight) measured slower on every case: its extra stage of
// shared memory cost more CTAs per SM than the overlap gave back. What is
// left, from globaltimer stamps at a p=85 CTA (ns from its start): index
// loads ~400, copies issued ~1,400, landed ~2,500, (x - b x_root) / s
// ~3,500, sum and cluster barrier ~5,000, stores ~5,400, after a ~1 us
// launch. The correlation tiles follow the data blocks in the same grid
// (rounded up to a whole cluster); they finish inside the rows' time.
//
// - a correlation tile is <= 2,048 entries of one dataset's rows, with b and
//   s (TPU mode: b and inv) of its columns and rows computed once per block
//   into shared memory, not once per element, while its entries load;
// - 16-byte loads and stores where rows are 16-byte aligned (n, resp. m, a
//   multiple of 4 and aligned base pointers), a scalar path otherwise;
// - each row stops at its dataset's valid count; dead rows (the root
//   included) and so dead datasets cost nothing in place.
//
// In-place choices (fit mode): every correlation block reads column `root`
// of c, so c' is always a second buffer (x_out == x is allowed, c_out == c
// is not); and c' is written in full, dead entries included, so it stays
// bit-equal to the plain version. x' may be written over x: a CTA writes
// only the columns it staged of its own row, the root row is dead and never
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
// refused with cudaErrorNotSupported, and so is a forced cluster size or
// row count the shape cannot take (cudaErrorInvalidValue). A launch the card
// refuses (a cluster it cannot place) returns its error. Launches on the
// given stream, does not synchronize, allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegVecs = 2;                        // TPU mode: float4 per thread per segment
constexpr int kSegCols = 4 * kThreads * kSegVecs;  // 2,048 columns per data block
constexpr int kTileElems = 8 * kThreads;           // 2,048 entries per correlation tile
constexpr int kColChunk = 2048;                    // columns of a correlation tile
constexpr int kTileRows = 64;                      // rows of a correlation tile at most
constexpr float kVarEps = 1e-12f;                  // covariance.VAR_EPS
constexpr float kFloor = 1e-4f;                    // covariance.COLLINEAR_FLOOR
constexpr int kTorchThreads = 512;                 // ATen reduce: most threads in a block
constexpr int kMaxCtas = 2048;                     // blocks per row of torch.sum replayed at most
constexpr int kSmemMax = 232448;                   // shared memory a block may use (227 KB)
constexpr int kSmemShare = 72 * 1024;              // a cluster CTA's staging for 3 CTAs per SM
constexpr int kBarBytes = 16;                      // the mbarrier, at the start of shared memory
constexpr int kRedSmall = 40;                      // cluster / warp paths: partials, sums, gains
constexpr int kMaxRows = 8;                        // rows of a block on the warp path
constexpr int kMaxPerSm = 4;                       // blocks per SM: the launch bounds

enum Mode { kModeData = 0, kModeCov = 1, kModeFit = 2, kModeRing = 3 };
// Ring mode's launches: sums and scale in one (samples whole), the sums and
// c' (before the sums are added across sample shards), the scale.
enum RingPhase { kRingFused = 0, kRingSums = 1, kRingScale = 2 };
// The kernel's kinds: TPU mode, fit mode, ring mode.
enum Kind { kTpu = 0, kFit = 1, kRing = 2 };
// A data row's path (see the top): over a cluster, R rows per block, one CTA.
enum Path { kPathCluster = 0, kPathWarps = 1, kPathRow = 2 };

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

// The data rows' plan of a fit- or ring-mode launch (`plan_rows`).
struct RowPlan {
  int path;
  int k;            // cluster path: CTAs per row (the cluster size); 1 otherwise
  int rows;         // warp path: rows per block; 1 otherwise
  int groups;       // warp path: blocks per dataset
  int staged;       // the rows' columns are held in shared memory
  int cap;          // floats staged per row (per CTA on the cluster path)
  int red;          // floats of the reduction area
  int smem;         // dynamic shared memory of a data block (bytes)
  int data_blocks;
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
  TorchSum order;         // fit and ring modes: torch.sum's order over (B * m, n)
  RowPlan plan;           // fit and ring modes: the data rows' path
  int m, n;
  int data_blocks, segs;  // data role: blocks, segments per row (TPU mode)
  int tile_rows, row_groups, col_chunks, cov_blocks;  // correlation role
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

// -- asynchronous copies and the cluster (sm_90)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's mbarrier for its bulk copies: one arrival (the thread that
// issues them), completed when every byte expected has landed.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

// Wait for the barrier's phase of `parity` to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One float global -> shared (the scalar path's staging), then all of them.
__device__ __forceinline__ void copy4b(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Every thread of every CTA of the cluster executes these (`aligned`).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// v into the float at `local`'s offset in the shared memory of CTA `rank`.
__device__ __forceinline__ void store_remote(const float* local, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(local)),
               "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
}

// -- the data rows of fit and ring modes

// One row of the data role: where it lies, its gates and valid count.
struct Row {
  const float* x;   // the row of x
  float* out;       // the row of x'
  const float* xr;  // the root's row
  float b, s;
  int nv;           // valid columns, in [0, n]
  int den;          // fit mode with valid counts: the variance's divisor; 0: times inv_den
  int id;           // the row's index in the (rows, n) squares torch sums
  int i;            // its index in its dataset's (ring mode: block's) rows
  int root;         // fit mode: its dataset's root
  bool live;
};

// A live row's gates b and s (fit mode: from column `root` of c).
template <int kKind>
__device__ __forceinline__ void set_gates(const Args& a, Row& r) {
  if (!r.live) return;
  if (kKind == kFit) {
    const float2 bs = gates(a.c[static_cast<size_t>(r.id) * a.m + r.root], true);
    r.b = bs.x;
    r.s = bs.y;
  } else {
    r.b = a.g_b[r.i];
    r.s = a.g_s[r.i];
  }
}

// Without `with_gates` b and s are left at 0 and 1 (`set_gates` reads them
// later: the paths issue their copies first, so the gates' loads overlap
// the copies).
template <int kKind>
__device__ __forceinline__ Row row_of(const Args& a, int d, int i, bool with_gates = true) {
  Row r;
  r.id = d * a.rows + i;
  r.i = i;
  r.x = a.x + static_cast<size_t>(r.id) * a.n;
  r.out = a.x_out + static_cast<size_t>(r.id) * a.n;
  r.b = 0.f;
  r.s = 1.f;
  r.root = 0;
  if (kKind == kFit) {
    r.root = static_cast<int>(a.roots[d]);
    r.live = a.mask[r.id] && i != r.root;
    r.xr = a.x + (static_cast<size_t>(d) * a.m + r.root) * a.n;
    const int nv_raw = a.n_valid ? a.n_valid[d] : a.n;
    r.nv = nv_raw < 0 ? 0 : (nv_raw > a.n ? a.n : nv_raw);
    r.den = a.n_valid ? (nv_raw - 1 > 1 ? nv_raw - 1 : 1) : 0;
  } else {
    r.live = a.live[i];
    r.xr = a.x_root;
    r.nv = a.n;
    r.den = 0;
  }
  if (with_gates) set_gates<kKind>(a, r);
  return r;
}

// The row's scale from its sum of squares (fit: over its valid count).
__device__ __forceinline__ float row_gain(const Args& a, const Row& r, float sum) {
  return row_scale(r.den ? __fdiv_rn(sum, static_cast<float>(r.den)) : __fmul_rn(sum, a.inv_den));
}

__device__ __forceinline__ float4 square4(float4 o) {
  return make_float4(__fmul_rn(o.x, o.x), __fmul_rn(o.y, o.y), __fmul_rn(o.z, o.z),
                     __fmul_rn(o.w, o.w));
}

// torch's per-thread combine of its four accumulators.
__device__ __forceinline__ float combine(float4 acc) {
  return __fadd_rn(__fadd_rn(__fadd_rn(acc.x, acc.y), acc.z), acc.w);
}

__device__ __forceinline__ float4 add4(float4 acc, float4 q) {
  return make_float4(__fadd_rn(acc.x, q.x), __fadd_rn(acc.y, q.y), __fadd_rn(acc.z, q.z),
                     __fadd_rn(acc.w, q.w));
}

// ATen's warp shuffles down by 16, 8, .., 1: lane 0 ends with the warp's sum.
__device__ __forceinline__ float warp_x_tree(float v) {
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// kUnroll vectors per thread per step of the staged loops: their loads are
// issued together, so as many divisions are in flight at once.
constexpr int kUnroll = 4;

// fn(L) for L = threadIdx.x, + kThreads, .. below `count`, kUnroll at a
// time: `load(L)` first for each, then `use(L, value)`.
template <typename Load, typename Use>
__device__ __forceinline__ void staged_loop(int count, Load load, Use use) {
  for (int L0 = threadIdx.x; L0 < count; L0 += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (L0 + t * kThreads < count) v[t] = load(L0 + t * kThreads);
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (L0 + t * kThreads < count) use(L0 + t * kThreads, v[t]);
    }
  }
}

// Part `part` of `parts` (blocks of kThreads) of a row copied; columns of a
// vector path as float4.
template <bool kVec>
__device__ void copy_part(const float* src, float* dst, int n, int part, int parts) {
  if (kVec) {
    for (int v = part * kThreads + threadIdx.x; 4 * v < n; v += parts * kThreads) {
      store4<true>(dst, 4 * v, n, load4<true>(src, 4 * v, n));
    }
  } else {
    for (int k = part * kThreads + threadIdx.x; k < n; k += parts * kThreads) dst[k] = src[k];
  }
}

// A dead row (the root included): unchanged (b = 0, s = 1, scale 1). Out of
// place it is copied; ring mode writes a 0 sum for it.
template <int kKind, bool kVec>
__device__ void dead_row(const Args& a, const Row& r, int part, int parts) {
  if (a.x_out != a.x && a.phase != kRingSums) copy_part<kVec>(r.x, r.out, a.n, part, parts);
  if (kKind == kRing && a.phase != kRingScale && part == 0 && threadIdx.x == 0) a.sq[r.i] = 0.f;
}

// Out of place, columns [from, n) of a live row are written +0 (part
// `part` of `parts`).
__device__ void zero_tail(const Args& a, const Row& r, int from, int part, int parts) {
  if (a.x_out == a.x) return;
  for (int k = from + part * kThreads + threadIdx.x; k < a.n; k += parts * kThreads) r.out[k] = 0.f;
}

template <int kKind>
__device__ __forceinline__ Row unit_row(const Args& a, int u, bool with_gates = true) {
  const int d = u / a.rows;
  return row_of<kKind>(a, d, u - d * a.rows, with_gates);
}

// Cluster path: CTA `rank` of the row's k replays torch's threads
// [rank * share, (rank + 1) * share), share = threads / k, whose vectors are
// the runs [j * threads + rank * share, +share) of x: run j lands at local
// vector j * share of xs. red: [0, 16) torch's warp partials (written by
// every CTA of the cluster), [16] the sum.
template <int kKind>
__device__ void cluster_row(const Args& a, int blk, uint64_t* bar, float* red, float* xs) {
  const int k = a.plan.k, rank = blk % k;
  Row r = unit_row<kKind>(a, blk / k, false);
  if (!r.live) {
    dead_row<kKind, true>(a, r, rank, k);
    return;
  }
  const bool sums = a.phase != kRingScale, stores = a.phase != kRingSums;
  const bool exchange = sums && k > 1;
  if (exchange) cluster_arrive_relaxed();  // running: the others may write into this CTA
  const int T = a.order.threads, share = T / k, v0 = rank * share, lg = __ffs(share) - 1;
  const int nvv = min(a.n / 4, ceil_div(r.nv, 4));  // vectors holding a valid column
  const int runs = v0 < nvv ? ceil_div(nvv - v0, T) : 0;
  if (threadIdx.x < 32) {  // warp 0 issues the copies, a run per lane
    if (threadIdx.x == 0) {
      uint32_t bytes = 0;
      for (int v = v0; v < nvv; v += T) bytes += 16u * min(share, nvv - v);
      bar_expect(bar, bytes);
    }
    __syncwarp();
    for (int j = threadIdx.x, v = v0 + j * T; v < nvv; j += 32, v += 32 * T) {
      const uint32_t cnt = 16u * min(share, nvv - v);
      bulk_copy(xs + 4 * (j << lg), r.x + 4 * v, cnt, bar);
    }
  }
  set_gates<kKind>(a, r);
  bar_wait(bar, 0);
  // x - b x_root over s, once per element, by every thread, over x's runs
  float4* xs4 = reinterpret_cast<float4*>(xs);
  const float4* xr4 = reinterpret_cast<const float4*>(r.xr);
  const auto vec_of = [&](int L) { return (L >> lg) * T + v0 + (L & (share - 1)); };
  staged_loop(
      runs << lg,
      [&](int L) {
        const float4 x = xs4[L], xr = __ldg(xr4 + vec_of(L));
        return fit4(x, xr, r.b, r.s, 4 * vec_of(L), r.nv);
      },
      [&](int L, float4 o) {
        if (vec_of(L) < nvv) xs4[L] = o;
      });
  __syncthreads();
  float total;
  if (sums) {
    const int lane = threadIdx.x % 32;
    if (exchange) cluster_wait();
    for (int w = threadIdx.x / 32; w < share / 32; w += kThreads / 32) {
      const int ul = 32 * w + lane;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int L = ul, v = v0 + ul; v < nvv; L += share, v += T) acc = add4(acc, square4(xs4[L]));
      const float val = warp_x_tree(combine(acc));
      if (lane == 0) {
        const int y = v0 / 32 + w;  // torch's warp
        if (k == 1) red[y] = val;
        else for (int c = 0; c < k; ++c) store_remote(red + y, c, val);
      }
    }
    if (exchange) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    if (threadIdx.x < 32) {  // torch's tree over its bh warps, in every CTA alike
      const int bh = T / 32;
      float v = lane < bh ? red[lane] : 0.f;
      for (int off = bh / 2; off > 0; off >>= 1) {
        const float other = __shfl_down_sync(0xffffffffu, v, off);
        if (lane < off) v = __fadd_rn(v, other);
      }
      if (lane == 0) red[16] = v;
    }
    __syncthreads();
    total = red[16];
    if (kKind == kRing && rank == 0 && threadIdx.x == 0) a.sq[r.i] = total;
  } else {
    total = a.sq[r.i];
  }
  if (!stores) return;
  const float g = row_gain(a, r, total);
  staged_loop(
      runs << lg, [&](int L) { return xs4[L]; },
      [&](int L, float4 o) {
        const int v = vec_of(L);
        if (v < nvv) store4<true>(r.out, 4 * v, r.nv, scale4(o, g, 4 * v, r.nv));
      });
  zero_tail(a, r, 4 * nvv, rank, k);
}

// Warp path: rows [i0, i0 + R) of one dataset per block, each staged whole
// (a.plan.cap floats a row), a copy per lane of warp 0; warp w replays row
// w's 32 threads. red: [8, 16) the gains, [16, 24) b, [24, 32) s, [32, 40)
// live.
template <int kKind>
__device__ void warp_rows(const Args& a, int blk, uint64_t* bar, float* red, float* xs) {
  const int d = blk / a.plan.groups;
  const int i0 = (blk - d * a.plan.groups) * a.plan.rows;
  const int cnt = min(a.plan.rows, a.rows - i0);
  float *gain = red + 8, *bs_b = red + 16, *bs_s = red + 24, *lv = red + 32;
  if (threadIdx.x < cnt) lv[threadIdx.x] = row_of<kKind>(a, d, i0 + threadIdx.x, false).live;
  __syncthreads();
  const Row first = row_of<kKind>(a, d, i0, false);  // x_root and the dataset's valid count
  int live = 0;
  for (int w = 0; w < cnt; ++w) {
    if (lv[w] != 0.f) ++live;
    else dead_row<kKind, true>(a, row_of<kKind>(a, d, i0 + w, false), 0, 1);
  }
  if (!live) return;
  const bool sums = a.phase != kRingScale, stores = a.phase != kRingSums;
  const int nv = first.nv, nvv = min(a.n / 4, ceil_div(nv, 4)), cap = a.plan.cap;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) bar_expect(bar, 16u * nvv * live);
    __syncwarp();
    const int w = threadIdx.x;  // lane w: row w
    if (nvv > 0 && w < cnt && lv[w] != 0.f) {
      bulk_copy(xs + w * cap, first.x + static_cast<size_t>(w) * a.n, 16u * nvv, bar);
    }
  }
  if (threadIdx.x < cnt) {
    const Row r = row_of<kKind>(a, d, i0 + threadIdx.x);
    bs_b[threadIdx.x] = r.b;
    bs_s[threadIdx.x] = r.s;
  }
  __syncthreads();
  bar_wait(bar, 0);
  // x - b x_root over s, once per element, by every thread
  const float4* xr4 = reinterpret_cast<const float4*>(first.xr);
  for (int w = 0; w < cnt; ++w) {
    if (lv[w] == 0.f) continue;
    float4* x4 = reinterpret_cast<float4*>(xs + w * cap);
    const float b = bs_b[w], sd = bs_s[w];
    staged_loop(
        nvv,
        [&](int v) {
          const float4 x = x4[v], xr = __ldg(xr4 + v);
          return fit4(x, xr, b, sd, 4 * v, nv);
        },
        [&](int v, float4 o) { x4[v] = o; });
  }
  __syncthreads();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w < cnt && lv[w] != 0.f) {
    const Row r = row_of<kKind>(a, d, i0 + w, false);
    float total;
    if (sums) {
      const float4* x4 = reinterpret_cast<const float4*>(xs + w * cap);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int v = lane; v < nvv; v += 32) acc = add4(acc, square4(x4[v]));
      total = __shfl_sync(0xffffffffu, warp_x_tree(combine(acc)), 0);
      if (kKind == kRing && lane == 0) a.sq[r.i] = total;
    } else {
      total = a.sq[r.i];
    }
    if (lane == 0) gain[w] = row_gain(a, r, total);
  }
  if (!stores) return;
  __syncthreads();
  for (int w = 0; w < cnt; ++w) {
    if (lv[w] == 0.f) continue;
    const float4* x4 = reinterpret_cast<const float4*>(xs + w * cap);
    const Row r = row_of<kKind>(a, d, i0 + w, false);
    const float g = gain[w];
    staged_loop(
        nvv, [&](int v) { return x4[v]; },
        [&](int v, float4 o) { store4<true>(r.out, 4 * v, nv, scale4(o, g, 4 * v, nv)); });
    zero_tail(a, r, 4 * nvv, 0, 1);
  }
}

// Row path: one CTA per row, staged whole when a.plan.staged (bulk copies
// in the vector path, 4-byte cp.async in the scalar one), else read from
// global memory twice; summed by the general replay (`torch_row_sum`).
// red: torch's thread values and block partials.
template <int kKind, bool kVec>
__device__ void one_row(const Args& a, int blk, uint64_t* bar, float* red, float* xs) {
  const int d = blk / a.rows;
  Row r = row_of<kKind>(a, d, blk - d * a.rows, false);
  if (!r.live) {
    dead_row<kKind, kVec>(a, r, 0, 1);
    return;
  }
  const bool staged = a.plan.staged;
  const int nv = r.nv;
  const int lim = kVec ? 4 * ceil_div(nv, 4) : nv;  // columns read and written
  if (staged) {
    if (kVec) {
      if (threadIdx.x == 0) {
        bar_expect(bar, 4u * lim);
        if (lim > 0) bulk_copy(xs, r.x, 4u * lim, bar);
      }
      set_gates<kKind>(a, r);
      bar_wait(bar, 0);
    } else {
      for (int k = threadIdx.x; k < nv; k += kThreads) copy4b(xs + k, r.x + k);
      set_gates<kKind>(a, r);
      copies_wait();
      __syncthreads();
    }
  } else {
    set_gates<kKind>(a, r);
  }
  if (staged) {  // x - b x_root over s, once per element, by every thread
    for (int k = threadIdx.x; k < nv; k += kThreads) xs[k] = fit_elem(xs[k], r.xr[k], r.b, r.s, true);
    __syncthreads();
  }
  // element e of (x - b x_root) / s
  const auto out_at = [&](int e) {
    return staged ? xs[e] : fit_elem(r.x[e], r.xr[e], r.b, r.s, true);
  };
  const bool sums = a.phase != kRingScale, stores = a.phase != kRingSums;
  float total;
  if (sums) {
    const auto square = [&](int e) {
      if (e >= nv) return 0.f;
      const float o = out_at(e);
      return __fmul_rn(o, o);
    };
    const int shift = static_cast<int>((static_cast<long long>(r.id) * a.n) & 3);
    total = torch_row_sum(a.order, a.n, nv, shift, square, red, red + kTorchThreads);
    if (kKind == kRing && threadIdx.x == 0) a.sq[r.i] = total;
  } else {
    total = a.sq[r.i];
  }
  if (!stores) return;
  const float g = row_gain(a, r, total);
  // The vector path writes whole float4: columns of the last one past nv
  // get +0, which is what the caller's padding holds.
  for (int k = (kVec ? 4 : 1) * threadIdx.x; k < lim; k += (kVec ? 4 : 1) * kThreads) {
    if (kVec) {
      const float4 o = staged ? *reinterpret_cast<const float4*>(xs + k)
                              : fit4(load4<true>(r.x, k, nv), load4<true>(r.xr, k, nv), r.b, r.s,
                                     k, nv);
      store4<true>(r.out, k, nv, scale4(o, g, k, nv));
    } else {
      r.out[k] = __fmul_rn(out_at(k), g);
    }
  }
  zero_tail(a, r, lim, 0, 1);
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

// TPU mode's kernel: data segments, then correlation tiles.
template <int kKind, bool kVecX, bool kVecC>
__global__ void __launch_bounds__(kThreads, 2) rank1_update_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int blk = blockIdx.x;
  if (blk < a.data_blocks) {
    tpu_data_segment<kVecX>(a, blk);
  } else {
    float2* col_g = reinterpret_cast<float2*>(smem4);
    cov_tile<kKind, kVecC>(a, blk - a.data_blocks, col_g,
                           col_g + (a.m < kColChunk ? a.m : kColChunk));
  }
}

// Fit and ring modes' kernel: the data rows on their path (see the top),
// then the correlation tiles, then blocks that round the grid up to a whole
// cluster. smem: the mbarrier, the reduction area (a.plan.red floats),
// x_root's staged columns, the rows' (a.plan.cap floats each).
template <int kKind, bool kVecX, bool kVecC>
__global__ void __launch_bounds__(kThreads, kMaxPerSm) rank1_update_kernel_rows(Args a) {
  extern __shared__ float4 smem4[];
  const int blk = blockIdx.x;
  if (blk < a.data_blocks) {
    unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
    uint64_t* bar = reinterpret_cast<uint64_t*>(base);
    float* red = reinterpret_cast<float*>(base + kBarBytes);
    float* xs = red + a.plan.red;  // the rows' staged columns
    // before the rows' index loads, so its release fence waits for nothing
    if (threadIdx.x == 0) bar_init(bar);
    __syncthreads();
    if constexpr (kVecX) {
      if (a.plan.path == kPathCluster) return cluster_row<kKind>(a, blk, bar, red, xs);
      if (a.plan.path == kPathWarps) return warp_rows<kKind>(a, blk, bar, red, xs);
    }
    one_row<kKind, kVecX>(a, blk, bar, red, xs);
  } else if (blk - a.data_blocks < a.cov_blocks) {
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
// in the order the row path replays: the check of that order.
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

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
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
    int dev = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    const int target = device_sms() * (per_sm / (bw * bh));
    if (rows <= target) {
      const int c1 = ceil_div(target, rows), c2 = ceil_div(per_thread, 16),
                c3 = ceil_div(per_thread, 256);
      const int lo = c1 < c2 ? c1 : c2;
      o->ctas = lo > c3 ? lo : c3;
    }
  }
  return o->ctas <= kMaxCtas;
}

// Shared memory of a block: the mbarrier, `red` floats, `rows` rows of `cap`
// floats.
int smem_of(int red, int cap, int rows) { return kBarBytes + 4 * red + 4 * cap * rows; }

// The data rows' plan (see the top) of `batch` datasets of `rows` rows of n
// columns, torch's order `o`, 16-byte rows or not; `want_k` / `want_rows`
// force the cluster size / the rows per block (0: chosen here). Returns 0,
// or cudaErrorInvalidValue for a forced shape the rows cannot take.
int plan_rows(int batch, int rows, int n, bool vec, const TorchSum& o, int sms, int want_k,
              int want_rows, RowPlan* p) {
  *p = RowPlan{};
  p->k = p->rows = p->groups = 1;
  const bool fast = vec && o.vec && o.bw == 32 && o.ctas == 1;
  const int total = batch * rows, nvec = n / 4;
  if (fast && o.split) {
    const int T = o.threads;
    int pick = 0;
    for (int k = 4; k >= 1; k >>= 1) {
      const int cap = 4 * ceil_div(nvec, T) * (T / k);
      const int smem = smem_of(kRedSmall, cap, 1);
      if (o.bh % k || smem > kSmemMax) continue;
      if (want_k) {
        if (k == want_k) pick = k;
      } else if (!pick || (k * total >= 4 * sms && smem <= kSmemShare)) {
        pick = k;
      }
    }
    if (pick) {
      p->path = kPathCluster;
      p->k = pick;
      p->cap = 4 * ceil_div(nvec, T) * (T / pick);
      p->red = kRedSmall;
      p->staged = 1;
      p->smem = smem_of(p->red, p->cap, 1);
      p->data_blocks = total * pick;
      return want_rows > 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
    }
  } else if (fast) {
    int pick = 0;
    for (int r = 1; r <= kMaxRows; r <<= 1) {
      if (smem_of(kRedSmall, n, r) > kSmemMax) break;
      if (want_rows ? r == want_rows : (r == 1 || batch * ceil_div(rows, r) >= sms)) pick = r;
    }
    if (pick) {
      p->path = kPathWarps;
      p->rows = pick;
      p->groups = ceil_div(rows, pick);
      p->cap = n;
      p->red = kRedSmall;
      p->staged = 1;
      p->smem = smem_of(p->red, p->cap, pick);
      p->data_blocks = batch * p->groups;
      return want_k > 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
    }
  }
  if (want_k > 1 || want_rows > 1) return static_cast<int>(cudaErrorInvalidValue);
  p->path = kPathRow;
  p->red = 4 * ceil_div(kTorchThreads + o.ctas, 4);
  p->cap = 4 * ceil_div(n, 4);
  p->staged = smem_of(p->red, p->cap, 1) <= kSmemMax;
  if (!p->staged) p->cap = 0;
  p->smem = smem_of(p->red, p->cap, 1);
  p->data_blocks = total;
  return 0;
}

// A fit- or ring-mode launch's whole plan: data rows, tiles, grid, smem.
struct Launch {
  TorchSum order;
  RowPlan rows;
  Plan tiles;
  int blocks, smem;
};

int launch_plan(int mode, int batch, int rows, int m, int n, bool vec, bool cov, int want_k,
                int want_rows, Launch* l) {
  if (!torch_sum_of(batch * rows, n, &l->order)) return static_cast<int>(cudaErrorNotSupported);
  const int rc = plan_rows(batch, rows, n, vec, l->order, device_sms(), want_k, want_rows, &l->rows);
  if (rc) return rc;
  l->tiles = plan_of(mode, batch, m, n, rows, cov);
  const int k = l->rows.k;
  l->blocks = k * ceil_div(l->rows.data_blocks + l->tiles.cov_blocks, k);
  const int w = m < kColChunk ? m : kColChunk;
  const int tiles = l->tiles.row_groups ? (w + kTileRows) * 8 : 0;
  l->smem = l->rows.smem > tiles ? l->rows.smem : tiles;
  return 0;
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
  a.cov_blocks = p.cov_blocks;
  return a;
}

// TPU mode's launch.
int launch_tpu(const Args& a, int blocks, bool vec_x, bool vec_c, cudaStream_t st) {
  auto kernel = vec_x ? (vec_c ? rank1_update_kernel<kTpu, true, true>
                               : rank1_update_kernel<kTpu, true, false>)
                      : (vec_c ? rank1_update_kernel<kTpu, false, true>
                               : rank1_update_kernel<kTpu, false, false>);
  const int w = a.m < kColChunk ? a.m : kColChunk;
  const int smem = a.row_groups ? (w + kTileRows) * 8 : 0;  // the correlation role's gates
  kernel<<<blocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `kernel` on `blocks` blocks in clusters of k, with `smem` bytes (its
// limit raised to kSmemMax once per kernel).
template <typename... Params>
int launch_clustered(void (*kernel)(Params...), bool& raised, int blocks, int k, int smem,
                     cudaStream_t st, Params... args) {
  if (!raised) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    raised = true;  // set twice at worst, harmlessly
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind>
int launch_rows(const Args& a, const Launch& l, bool vec_x, bool vec_c, cudaStream_t st) {
  auto kernel = vec_x ? (vec_c ? rank1_update_kernel_rows<kKind, true, true>
                               : rank1_update_kernel_rows<kKind, true, false>)
                      : (vec_c ? rank1_update_kernel_rows<kKind, false, true>
                               : rank1_update_kernel_rows<kKind, false, false>);
  static bool raised[4] = {false, false, false, false};  // per instantiation
  return launch_clustered(kernel, raised[2 * vec_x + vec_c], l.blocks, l.rows.k, l.smem, st, a);
}

// Args of a fit- or ring-mode launch from its plan.
Args rows_args(const Launch& l, int m, int n, int rows) {
  Args a = args_of(l.tiles, m, n, rows);
  a.order = l.order;
  a.plan = l.rows;
  a.data_blocks = l.rows.data_blocks;
  return a;
}

// The launch plan of `mode` (kModeFit: batch datasets of m rows; kModeRing:
// `batch` is the block's rows m_l, of an (m_l, m) correlation block).
int mode_plan(int mode, int batch, int m, int n, bool vec, int want_k, int want_rows, Launch* l) {
  return mode == kModeRing ? launch_plan(mode, 1, batch, m, n, vec, true, want_k, want_rows, l)
                           : launch_plan(mode, batch, m, m, n, vec, true, want_k, want_rows, l);
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
  return launch_tpu(a, plan.data_blocks, vec, false, static_cast<cudaStream_t>(stream));
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
  return launch_tpu(a, plan.cov_blocks, false, vec, static_cast<cudaStream_t>(stream));
}

// Fit mode; `cluster` and `rows` force the data rows' cluster size and rows
// per block (0: chosen by the plan).
extern "C" int rank1_update_launch(const void* x, void* x_out, const void* c,
                                   void* c_out, const void* roots,
                                   const void* mask, const void* n_valid,
                                   int batch, int m, int n, int cluster, int rows,
                                   void* stream) {
  if (batch < 1 || m < 1 || n < 1 || c_out == c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_x = n % 4 == 0 && aligned16(x) && aligned16(x_out);
  const bool vec_c = m % 4 == 0 && aligned16(c) && aligned16(c_out);
  Launch l;
  const int rc = launch_plan(kModeFit, batch, m, m, n, vec_x, true, cluster, rows, &l);
  if (rc) return rc;
  Args a = rows_args(l, m, n, m);
  a.x = static_cast<const float*>(x);
  a.x_out = static_cast<float*>(x_out);
  a.c = static_cast<const float*>(c);
  a.c_out = static_cast<float*>(c_out);
  a.roots = static_cast<const long long*>(roots);
  a.mask = static_cast<const unsigned char*>(mask);
  a.n_valid = static_cast<const int*>(n_valid);
  // torch's CUDA division by a Python number: a * (1 / b), 1 / b in float
  a.inv_den = 1.f / static_cast<float>(n - 1 > 1 ? n - 1 : 1);
  return launch_rows<kFit>(a, l, vec_x, vec_c, static_cast<cudaStream_t>(stream));
}

// Ring mode, one launch of `phase` (see the top): x (m_l, n) and x_root (n,)
// this rank's sample shard, c (m_l, m) the rows [row0, row0 + m_l), the
// gates b, s (m_l,) and b_col, s_col (m,), live (m_l,) uint8, sq (m_l,) the
// sums (written by kRingFused and kRingSums, read by kRingScale), n_total
// the global sample count. x_out may be x, c_out may be c; kRingScale reads
// and writes x only. `cluster`, `rows` as in rank1_update_launch.
extern "C" int ring_update_launch(const void* x, void* x_out, const void* c, void* c_out,
                                  const void* x_root, const void* b, const void* s,
                                  const void* b_col, const void* s_col, const void* live,
                                  void* sq, int phase, int m_l, int m, int n, int row0,
                                  int n_total, int cluster, int rows, void* stream) {
  if (m_l < 1 || m < 1 || n < 1 || phase < kRingFused || phase > kRingScale || row0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_x = n % 4 == 0 && aligned16(x) && aligned16(x_out) && aligned16(x_root);
  const bool vec_c = m % 4 == 0 && aligned16(c) && aligned16(c_out);
  Launch l;
  const int rc = launch_plan(kModeRing, 1, m_l, m, n, vec_x, phase != kRingScale, cluster, rows,
                             &l);
  if (rc) return rc;
  Args a = rows_args(l, m, n, m_l);
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
  a.inv_den = 1.f / static_cast<float>(n_total - 1 > 1 ? n_total - 1 : 1);
  return launch_rows<kRing>(a, l, vec_x, vec_c, static_cast<cudaStream_t>(stream));
}

// The grid of a launch: mode 0 update_data (batch 1), 1 update_cov (batch
// 1, n ignored), 2 the fit mode, 3 ring mode's first launch (batch is m_l,
// its rows: its data blocks and the tiles of the (m_l, m) block), the fit
// and ring modes on 16-byte rows (n a multiple of 4) or not.
extern "C" int rank1_update_blocks(int mode, int batch, int m, int n) {
  if (mode == kModeData || mode == kModeCov) {
    const Plan p = plan_of(mode, batch, m, n, m);
    return p.data_blocks + p.cov_blocks;
  }
  Launch l;
  return mode_plan(mode, batch, m, n, n % 4 == 0, 0, 0, &l) ? -1 : l.blocks;
}

// An empty kernel on the grid of a launch: the launch floor. Fit and ring
// modes' floor takes their clusters and shared memory too.
extern "C" int rank1_update_empty_launch(int mode, int batch, int m, int n, void* stream) {
  if (batch < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kModeData || mode == kModeCov) {
    rank1_update_empty<<<rank1_update_blocks(mode, batch, m, n), kThreads, 0, st>>>();
    return static_cast<int>(cudaGetLastError());
  }
  Launch l;
  const int rc = mode_plan(mode, batch, m, n, n % 4 == 0, 0, 0, &l);
  if (rc) return rc;
  static bool raised = false;
  return launch_clustered(rank1_update_empty, raised, l.blocks, l.rows.k, l.smem, st);
}

// The plan of a fit- or ring-mode launch (mode, batch, m, n as in
// rank1_update_blocks; vec: 16-byte rows; cluster, rows: forced or 0), as
// 14 ints: torch's bw, bh, split, ctas, vectors, threads; the path, cluster
// size, rows per block, staged, floats staged per row, data blocks, blocks
// and shared memory bytes. Returns the plan's error, if any.
extern "C" int rank1_update_plan(int mode, int batch, int m, int n, int vec, int cluster, int rows,
                                 int* out) {
  if (batch < 1 || m < 1 || n < 1 || (mode != kModeFit && mode != kModeRing)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch l;
  const int rc = mode_plan(mode, batch, m, n, vec != 0, cluster, rows, &l);
  if (rc) return rc;
  const int vals[14] = {l.order.bw,   l.order.bh,     l.order.split,     l.order.ctas,
                        l.order.vec,  l.order.threads, l.rows.path,      l.rows.k,
                        l.rows.rows,  l.rows.staged,  l.rows.cap,        l.rows.data_blocks,
                        l.blocks,     l.smem};
  for (int i = 0; i < 14; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int rank1_scale_probe(const void* var, void* out, int count, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  scale_probe<<<ceil_div(count, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(var), static_cast<float*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

// torch.sum(x * x, -1) of a contiguous (rows, n) float32 tensor in the order
// the row path replays (the check of that order against torch itself).
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

// Square pairwise moments kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pairwise_moments_kernel` in
// src/repro/kernels/pairwise_score.py:46 (entry `pairwise_moments`; the
// batched entry runs the same body over a leading dataset axis). It computes
// the same function:
//
//   for every ordered pair (i, j) of a row of xi and a row of xj, the raw
//   sums over the samples k of log cosh u_ij[k] and u_ij[k] exp(-u_ij[k]^2/2),
//   with u_ij = (xi_i - c_ij xj_j) * rsqrt(max(1 - c_ij^2, 1e-12)).
//   No 1/n and no entropy: the caller divides by the valid count and takes
//   the Hyvarinen entropy (pairwise.finalize_moments).
//
// What bounds it on the card: every (ordered pair, sample) element costs three
// transcendentals (exp and log1p for log cosh, exp for the second moment),
// so the kernel is bound by the special-function units and the FP32 pipes
// that run the libdevice expansions, not by memory: an 8 x 8 tile reads
// 16 * n floats and does 192 * n transcendentals. The design keeps the HBM
// traffic at that minimum and everything else on chip: each block stages
// BLOCK_N-sample slices of its 8 rows of xi and 8 rows of xj in shared memory
// (each value read by 8 threads), computes 1 / sqrt(max(1 - c^2, 1e-12)) once
// per pair and keeps it in a register, and keeps both sums of its pair in
// registers across the whole sample sweep. A tile is spread over 64 * lanes
// threads, lanes chosen from the tile count so that the small buffers of the
// late causal-order stages still fill the SMs.
//
// Determinism: one block per (8 x 8 output tile, dataset) on a
// (tiles_i, tiles_j, B) grid writes each sum once, after a lane reduction in
// a fixed order. No atomics. The lane count, and so every sum's order,
// depends on the per-dataset tile count only, never on B: row b of a batched
// launch is bit-identical to a one-dataset launch of dataset b.
//
// Contract (see pairwise_score.py): xi (B, pi, n), xj (B, pj, n), c (B, pi, pj)
// float32, contiguous; m1, m2 (B, pi, pj) float32 outputs. Any pi, pj and n:
// rows past the edge read as 0 and are never written (selects, not multiplies
// with a mask), the last sample chunk is ragged. Zero sample columns add
// exactly 0 to both sums (log cosh 0 is taken as exactly 0), and the sums are
// taken chunk by chunk from sample 0, so zero-padding n leaves every sum bit
// for bit as it was. Launches on the given stream, does not synchronize,
// allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBI = 8;
constexpr int kBJ = 8;
constexpr int kPairs = kBI * kBJ;
constexpr int kBlockN = 512;
constexpr int kLd = kBlockN + 1;  // odd stride: the 8 rows land in distinct banks
constexpr float kVarEps = 1e-12f;
constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float log_cosh(float u) {
  const float a = fabsf(u);
  return a == 0.f ? 0.f : a + log1pf(expf(-2.f * a)) - kLn2;
}

// u exp(-u^2/2) with every product rounded on its own (no FMA contraction),
// as the plain version's separate torch ops round them.
__device__ __forceinline__ float u_exp(float u) {
  return __fmul_rn(u, expf(__fmul_rn(-0.5f, __fmul_rn(u, u))));
}

__global__ void pairwise_moments_tiles(const float* __restrict__ xi,
                                       const float* __restrict__ xj,
                                       const float* __restrict__ c,
                                       float* __restrict__ m1,
                                       float* __restrict__ m2,
                                       int pi, int pj, int n, int lanes) {
  __shared__ float sx[2 * kBI * kLd];
  float* sxi = sx;
  float* sxj = sx + kBI * kLd;
  const int i0 = blockIdx.x * kBI;
  const int j0 = blockIdx.y * kBJ;
  const int bat = blockIdx.z;
  const int tid = threadIdx.x;
  const int pair = tid % kPairs;
  const int lane = tid / kPairs;
  const int a = pair / kBJ;
  const int q = pair % kBJ;
  const int row_i = i0 + a;
  const int row_j = j0 + q;
  const bool in_range = row_i < pi && row_j < pj;
  const float* xib = xi + static_cast<size_t>(bat) * pi * n;
  const float* xjb = xj + static_cast<size_t>(bat) * pj * n;

  const float cij =
      in_range ? c[(static_cast<size_t>(bat) * pi + row_i) * pj + row_j] : 0.f;
  float v = __fsub_rn(1.f, __fmul_rn(cij, cij));
  v = v < kVarEps ? kVarEps : v;  // clamp that keeps NaN
  const float inv = 1.f / sqrtf(v);

  float s1 = 0.f, s2 = 0.f;
  for (int base = 0; base < n; base += kBlockN) {
    const int w = min(kBlockN, n - base);
    __syncthreads();
    for (int e = tid; e < kBI * w; e += blockDim.x) {
      const int r = e / w;
      const int k = e - r * w;
      const int gi = i0 + r;
      const int gj = j0 + r;
      sxi[r * kLd + k] = gi < pi ? xib[static_cast<size_t>(gi) * n + base + k] : 0.f;
      sxj[r * kLd + k] = gj < pj ? xjb[static_cast<size_t>(gj) * n + base + k] : 0.f;
    }
    __syncthreads();
    const float* xi_row = sxi + a * kLd;
    const float* xj_row = sxj + q * kLd;
    // Chunk-local sums, then one add per chunk: two-level summation keeps the
    // f32 rounding of a long sample sweep near that of a tree sum.
    float c1 = 0.f, c2 = 0.f;
    for (int k = lane; k < w; k += lanes) {
      const float u = __fmul_rn(__fsub_rn(xi_row[k], __fmul_rn(cij, xj_row[k])), inv);
      c1 = __fadd_rn(c1, log_cosh(u));
      c2 = __fadd_rn(c2, u_exp(u));
    }
    s1 = __fadd_rn(s1, c1);
    s2 = __fadd_rn(s2, c2);
  }

  // Lane reduction in a fixed order, reusing the staging buffer.
  __syncthreads();
  sx[lane * kPairs + pair] = s1;
  sx[(lanes + lane) * kPairs + pair] = s2;
  __syncthreads();
  if (lane == 0 && in_range) {
    float a1 = 0.f, a2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a1 = __fadd_rn(a1, sx[l * kPairs + pair]);
      a2 = __fadd_rn(a2, sx[(lanes + l) * kPairs + pair]);
    }
    const size_t o = (static_cast<size_t>(bat) * pi + row_i) * pj + row_j;
    m1[o] = a1;
    m2[o] = a2;
  }
}

}  // namespace

extern "C" int pairwise_moments_launch(const void* xi, const void* xj,
                                       const void* c, void* m1, void* m2,
                                       int batch, int pi, int pj, int n,
                                       int lanes, void* stream) {
  if (lanes < 1 || kPairs * lanes > 1024 || 2 * lanes * kPairs > 2 * kBI * kLd) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((pi + kBI - 1) / kBI, (pj + kBJ - 1) / kBJ, batch);
  pairwise_moments_tiles<<<grid, kPairs * lanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xj),
      static_cast<const float*>(c), static_cast<float*>(m1),
      static_cast<float*>(m2), pi, pj, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

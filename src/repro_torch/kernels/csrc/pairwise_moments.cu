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
// What bounds it on the card: the FP32 pipe. Every (ordered pair, sample)
// element runs the math of one direction of the fused sweep (fused_score.cu,
// the same device functions from lingam_math.cuh): the residual, log cosh u
// with the polynomial log1p_unit and u exp(-u^2/2), two libdevice expf (one
// MUFU each) and ~32 FP32 instructions, while an 8 x 8 tile reads only
// 16 floats per sample. The design spends the instruction slots on that math
// and on nothing else it can avoid:
//
// - a thread owns a 2 x 2 micro-tile of pairs, so each sample it reads from
//   shared memory (two rows of xi, two of xj) feeds four pairs: one shared
//   load per element, and the loop control and addressing shared by four;
// - optional live-row masks and valid sample counts: a tile with no live
//   pair writes zeros and returns before it stages a sample, a warp whose
//   four pairs are all dead skips the math, dead rows are not staged, and a
//   dataset's sample loop stops at its own valid count;
// - samples are staged with cp.async into a double buffer of kStage-sample
//   sub-chunks, so sub-chunk s+1 lands while s is computed; a row whose
//   start is 16-byte aligned is copied 16 bytes at a time, any other row
//   4 bytes at a time.
//
// Thread layout: 16 micro-tiles x lanes threads per block, lanes (32 or 64)
// fastest, so a warp holds one micro-tile (the dead-warp skip is uniform)
// and its lanes read consecutive samples of one row (no bank conflicts).
// Lanes are chosen from the per-dataset tile count (pairwise_score._lanes).
//
// Exactness: the sums are taken in chunks of kBlockN samples counted from
// sample 0 (chunk-local sums, then one add per chunk), each thread visiting
// the samples lane, lane + lanes, ... of a chunk in order; the lanes of a
// warp are added by a fixed butterfly, then the warps of a micro-tile in
// order. The loops stop at the valid count, and the staging sub-chunks do
// not change the order in which a thread adds its samples. So a zero-padded
// launch with valid counts and an unpadded launch on the first n_valid
// columns give the same bits, and row b of a batched launch is bit-identical
// to a one-dataset launch of dataset b (lanes never depends on B or n). No
// atomics: one block per (8 x 8 output tile, dataset) on a
// (tiles_i, tiles_j, B) grid writes each sum once.
//
// Contract (see pairwise_score.py): xi (B, pi, n), xj (B, pj, n), c (B, pi, pj)
// float32, contiguous; live_i (B, pi), live_j (B, pj) bool, or null for all
// rows live; nv (B,) int32 valid sample counts, or null for all n samples;
// m1, m2 (B, pi, pj) float32 outputs, exactly 0 on every dead pair (a
// select: dead rows may hold anything). Any pi, pj and n: rows past the edge
// are never read or written, the last sample chunk is ragged. Launches on
// the given stream, does not synchronize, allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lingam_math.cuh"  // log_cosh, u_exp, valid_count, cp_async*

namespace {

constexpr int kBI = 8;  // rows of xi per tile (pairwise_score.BLOCK_I)
constexpr int kBJ = 8;  // rows of xj per tile
constexpr int kMicro = 2;  // a thread's pairs: kMicro x kMicro
constexpr int kMicroCols = kBJ / kMicro;
constexpr int kMicroTiles = (kBI / kMicro) * kMicroCols;  // 16
constexpr int kPairs = kMicro * kMicro;
constexpr int kBlockN = 512;  // samples per summation chunk (pairwise_score.BLOCK_N)
constexpr int kStage = 256;   // samples per staged sub-chunk; divides kBlockN
constexpr int kVecs = kStage / 4;
constexpr int kRows = kBI + kBJ;  // staged rows: xi's, then xj's
// Row stride = kStage: a multiple of 4 floats (16-byte cp.async targets); a
// warp reads 32 consecutive samples of one row, so no padding is needed.
constexpr int kBufFloats = kRows * kStage;
constexpr int kMaxThreads = 1024;

// Bit r: row r of the 8-row block at r0 is in range and live.
__device__ __forceinline__ unsigned live_rows(const unsigned char* live, int r0, int p) {
  unsigned bits = 0;
  for (int r = 0; r < 8; ++r) {
    const int g = r0 + r;
    if (g < p && (live == nullptr || live[g])) bits |= 1u << r;
  }
  return bits;
}

__global__ void __launch_bounds__(kMaxThreads)
pairwise_moments_tiles(const float* __restrict__ xi, const float* __restrict__ xj,
                       const float* __restrict__ c,
                       const unsigned char* __restrict__ live_i,
                       const unsigned char* __restrict__ live_j,
                       const int* __restrict__ nv, float* __restrict__ m1,
                       float* __restrict__ m2, int pi, int pj, int n, int lanes) {
  __shared__ __align__(16) float smem[2 * kBufFloats];
  const int i0 = blockIdx.x * kBI;
  const int j0 = blockIdx.y * kBJ;
  const int bat = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % lanes;
  const int mt = tid / lanes;
  const int a0 = (mt / kMicroCols) * kMicro;
  const int q0 = (mt % kMicroCols) * kMicro;
  const size_t obase = static_cast<size_t>(bat) * pi * pj;

  // The live-tile rule, uniform over the block: a live pair needs a live
  // row in each block.
  const unsigned rows_i = live_rows(
      live_i == nullptr ? nullptr : live_i + static_cast<size_t>(bat) * pi, i0, pi);
  const unsigned rows_j = live_rows(
      live_j == nullptr ? nullptr : live_j + static_cast<size_t>(bat) * pj, j0, pj);
  if (rows_i == 0 || rows_j == 0) {
    if (tid < kBI * kBJ) {
      const int gi = i0 + tid / kBJ;
      const int gj = j0 + tid % kBJ;
      if (gi < pi && gj < pj) {
        const size_t o = obase + static_cast<size_t>(gi) * pj + gj;
        m1[o] = 0.f;
        m2[o] = 0.f;
      }
    }
    return;
  }

  float cf[kPairs], inv[kPairs];
  bool busy = false;
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int a = a0 + e / kMicro;
    const int q = q0 + e % kMicro;
    const bool live = (rows_i >> a & 1u) && (rows_j >> q & 1u);
    busy |= live;
    cf[e] = live ? c[obase + static_cast<size_t>(i0 + a) * pj + j0 + q] : 0.f;
    float v = __fsub_rn(1.f, __fmul_rn(cf[e], cf[e]));
    v = v < kVarEps ? kVarEps : v;  // clamp that keeps NaN
    inv[e] = 1.f / sqrtf(v);
  }

  // Staging: rows 0..7 of a buffer are xi's, 8..15 xj's. Rows that no live
  // pair reads (dead or past the edge) are not copied.
  const int nvb = valid_count(nv, bat, n);
  const float* xib = xi + static_cast<size_t>(bat) * pi * n;
  const float* xjb = xj + static_cast<size_t>(bat) * pj * n;
  auto stage = [&](int s0, int buf) {
    const int w = min(kStage, nvb - s0);
    float* dst0 = smem + buf * kBufFloats;
    for (int e = tid; e < kRows * kVecs; e += blockDim.x) {
      const int r = e / kVecs;
      const int k = (e % kVecs) * 4;
      const bool side_i = r < kBI;
      const int lr = side_i ? r : r - kBI;
      if (k >= w || !((side_i ? rows_i : rows_j) >> lr & 1u)) continue;
      const float* row = side_i ? xib + static_cast<size_t>(i0 + lr) * n
                                : xjb + static_cast<size_t>(j0 + lr) * n;
      const int m = min(4, w - k);
      float* dst = dst0 + r * kStage + k;
      if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        cp_async16(dst, row + s0 + k, 4 * m);
      } else {
        for (int h = 0; h < m; ++h) cp_async4(dst + h, row + s0 + k + h);
      }
    }
    cp_async_commit();
  };

  float s1[kPairs], s2[kPairs], c1[kPairs], c2[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) s1[e] = s2[e] = c1[e] = c2[e] = 0.f;
  const int nsub = (nvb + kStage - 1) / kStage;
  if (nsub > 0) stage(0, 0);
  for (int s = 0; s < nsub; ++s) {
    if (s + 1 < nsub) {
      stage((s + 1) * kStage, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (busy) {  // uniform over the warp: a warp is one micro-tile
      const int w = min(kStage, nvb - s * kStage);
      const float* buf = smem + (s & 1) * kBufFloats;
      const float* xa0 = buf + a0 * kStage;
      const float* xa1 = xa0 + kStage;
      const float* xq0 = buf + (kBI + q0) * kStage;
      const float* xq1 = xq0 + kStage;
      for (int k = lane; k < w; k += lanes) {
        const float xa[kMicro] = {xa0[k], xa1[k]};
        const float xq[kMicro] = {xq0[k], xq1[k]};
#pragma unroll
        for (int e = 0; e < kPairs; ++e) {
          const float u = __fmul_rn(
              __fsub_rn(xa[e / kMicro], __fmul_rn(cf[e], xq[e % kMicro])), inv[e]);
          // Chunk-local sums, then one add per chunk: two-level summation
          // keeps the f32 rounding of a long sample sweep near a tree sum's.
          c1[e] += log_cosh(u);
          c2[e] += u_exp(u);
        }
      }
    }
    if ((s + 1) % (kBlockN / kStage) == 0 || s + 1 == nsub) {  // end of a chunk
#pragma unroll
      for (int e = 0; e < kPairs; ++e) {
        s1[e] += c1[e];
        s2[e] += c2[e];
        c1[e] = c2[e] = 0.f;
      }
    }
    __syncthreads();  // the next iteration stages into this buffer
  }

  // Lane reduction in a fixed order: a butterfly over the 32 lanes of each
  // warp, then the micro-tile's warps in ascending order.
  float v[2 * kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    v[e] = s1[e];
    v[kPairs + e] = s2[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < 2 * kPairs; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
  }
  const int warps = lanes / 32;
  float* red = smem;  // free: the loop ended on a barrier, or staged nothing
  if (lane % 32 == 0) {
#pragma unroll
    for (int e = 0; e < 2 * kPairs; ++e) red[(mt * warps + lane / 32) * 2 * kPairs + e] = v[e];
  }
  __syncthreads();
  if (tid < kMicroTiles * 2 * kPairs) {
    const int t_mt = tid / (2 * kPairs);
    const int e2 = tid % (2 * kPairs);
    const float* part = red + t_mt * warps * 2 * kPairs + e2;
    float acc = part[0];
    for (int w2 = 1; w2 < warps; ++w2) acc += part[w2 * 2 * kPairs];
    const int e = e2 % kPairs;
    const int a = (t_mt / kMicroCols) * kMicro + e / kMicro;
    const int q = (t_mt % kMicroCols) * kMicro + e % kMicro;
    if (i0 + a < pi && j0 + q < pj) {
      const bool live = (rows_i >> a & 1u) && (rows_j >> q & 1u);
      float* out = e2 < kPairs ? m1 : m2;
      out[obase + static_cast<size_t>(i0 + a) * pj + j0 + q] = live ? acc : 0.f;
    }
  }
}

}  // namespace

extern "C" int pairwise_moments_launch(const void* xi, const void* xj, const void* c,
                                       const void* live_i, const void* live_j,
                                       const void* nv, void* m1, void* m2, int batch,
                                       int pi, int pj, int n, int lanes, void* stream) {
  if (batch < 1 || pi < 1 || pj < 1 || n < 1 || lanes < 32 || lanes % 32 != 0 ||
      kMicroTiles * lanes > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((pi + kBI - 1) / kBI, (pj + kBJ - 1) / kBJ, batch);
  pairwise_moments_tiles<<<grid, kMicroTiles * lanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xj),
      static_cast<const float*>(c), static_cast<const unsigned char*>(live_i),
      static_cast<const unsigned char*>(live_j), static_cast<const int*>(nv),
      static_cast<float*>(m1), static_cast<float*>(m2), pi, pj, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the tile kernel at a lane count (registers and
// shared memory as compiled), for chip_smoke.py's report.
extern "C" int pairwise_moments_occupancy(int lanes, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pairwise_moments_tiles, kMicroTiles * lanes, 0));
}

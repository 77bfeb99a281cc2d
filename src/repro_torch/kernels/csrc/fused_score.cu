// Fused triangular score sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_tri_kernel` in src/repro/kernels/fused_score.py
// (entries `fused_score_vector` and, over a bucket of datasets on a (T, B)
// grid, `fused_score_batch`), together with the jnp prologue the JAX wrapper
// runs before it (row entropies, diagonal tiles). It computes the same
// function, not the same block schedule:
//
//   for every pair of row blocks (i <= j) of size b, stream the valid samples
//   of the two blocks and accumulate, for every row pair (a, q), four raw
//   sums: sum log cosh u and sum u exp(-u^2/2) for the forward residual
//   u_f = (x_a - c_aq x_q) / sqrt(1 - c_aq^2) and the reverse residual
//   u_r = (x_q - c_qa x_a) / sqrt(1 - c_qa^2). Divide by the valid count, take
//   the Hyvarinen entropies, form I = (H_q - H_a) + (HR_f - HR_r) and credit
//   min(0, I)^2 to row a and min(0, -I)^2 to row q (masked by select, never
//   by multiply: dead rows may hold non-finite data). A diagonal tile (i, i)
//   takes each of its in-block pairs a < q once, and both credits go to its
//   own rows. The row entropies H come from a first, small kernel with the
//   same chunked sample loop.
//
// What bounds it on the card: every (pair, sample) of the sweep costs three
// transcendentals per direction (exp, log1p, exp): libdevice's expf is one
// MUFU instruction and seven FP32 ones, log1p_unit eleven FP32 ones. So the
// sweep is bound by the FP32 pipe (64 FP32 instructions, of 83 in all, and 4
// MUFU per (pair, sample), printed by chip_smoke.py), then by the
// special-function units, not by memory: a tile reads 2*b*n floats and
// issues ~b*b*n*64 FP32 instructions. The design therefore keeps every sample in shared memory (a
// b-row slice of x_i and of x_j, reused by b threads each), keeps the four
// sums in registers, spreads one tile over b*b*lanes threads so that even the
// small late stages of the causal-order scan put enough warps on the SMs,
// and spends nothing on work that no score needs:
//
// - each dataset's sample loop stops at its own valid count (n_valid),
//   instead of sweeping the bucket's padded n;
// - a tile whose two row blocks hold no live pair writes zero partials and
//   returns before it stages a sample (the late iterations of a bucket are
//   mostly such tiles);
// - samples are staged with cp.async into a double buffer of kStage-sample
//   sub-chunks, so sub-chunk s+1 lands while s is computed. A row whose start
//   is 16-byte aligned is copied 16 bytes at a time, any other row 4 bytes at
//   a time.
//
// Exactness: the sums are taken in chunks of kBlockN samples counted from
// sample 0 (chunk-local sums, then one add per chunk), each thread visiting
// the samples lane, lane + lanes, ... of a chunk, and the lanes are added in
// a fixed order. The loops stop at the valid count, and the staging
// sub-chunks do not change the order in which a thread adds its samples. So a
// zero-padded launch with n_valid and an unpadded launch on the first n_valid
// columns give the same bits, and a dataset's scores do not depend on the batch it rides in (lanes
// is chosen from the per-dataset tile count, never from B or n).
//
// Determinism: the TPU kernel adds every tile into one resident output in
// grid order. Blocks here run concurrently, so each tile writes its partial
// row (and column) sums to its own slots of a scratch buffer, and a last
// kernel adds, for each row, its diagonal tile's partial to the sum of its
// other partials in ascending row-block order. No atomics: the f32 sum order,
// and so the causal order, is the same on every run.
//
// Contract (see fused_score.py): x (B, p, n), c (B, p, p) float32, mask (B, p)
// bool, all contiguous as the caller holds them; nv (B,) int32 valid sample
// counts, or null for all n samples; imap, jmap (T,) int32 tile maps with
// T = nt (nt + 1) / 2, nt = ceil(p / b); scratch B * (p + nt * nt * b) floats
// (row entropies, then the (B, nt, nt, b) partial slots); out (B, p) scores
// (+inf on dead rows); smem_bytes the tile kernel's dynamic shared memory,
// max(two staging buffers of 2 * b * kLd floats, the lane reduction's
// 4 * b * b * lanes + 2 * b * b floats). Any p and n: rows >= p of the last block are never
// read and are masked. Launches on the given stream, does not synchronize,
// allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lingam_math.cuh"  // log1p_unit, log_cosh, u_exp, valid_count, cp_async*

namespace {

constexpr float kK1 = 79.047f;
constexpr float kK2 = 7.4129f;
constexpr float kBeta = 0.37457f;
constexpr float kHGauss = 1.4189385332046727f;  // (1 + log 2 pi) / 2

constexpr int kBlockN = 512;  // samples per summation chunk (fused_score.BLOCK_N)
constexpr int kStage = 128;   // samples per staged sub-chunk; divides kBlockN
constexpr int kVecs = kStage / 4;
// Shared row stride in floats: a multiple of 4 (16-byte cp.async targets),
// and 4 (mod 32), so rows q = 0..7 read at one sample land on banks 4q: the
// 8 distinct rows a warp reads at b = 8 never share a bank.
constexpr int kLd = kStage + 4;  // fused_score.STAGE_LD
constexpr int kEntropyThreads = 128;

__device__ __forceinline__ float entropy(float m1, float m2) {
  const float d = m1 - kBeta;
  return kHGauss - kK1 * (d * d) - kK2 * (m2 * m2);
}

// min(0, v)^2, NaN-propagating like the plain version's clamp.
__device__ __forceinline__ float neg_sq(float v) {
  const float m = v > 0.f ? 0.f : v;
  return m * m;
}

// The finalize denominator, max(n_valid, 1) as the plain version divides.
__device__ __forceinline__ float denominator(const int* nv, int bat, int n) {
  const int v = nv == nullptr ? n : nv[bat];
  return static_cast<float>(v < 1 ? 1 : v);
}

// H of each live row (0 on dead rows), one block of kEntropyThreads per
// (row, dataset): chunk-local lane sums over the valid samples, then the lanes
// added in order by thread 0.
__global__ void row_entropies(const float* __restrict__ x,
                              const unsigned char* __restrict__ mask,
                              const int* __restrict__ nv, float* __restrict__ hx,
                              int p, int n) {
  __shared__ float red[2 * kEntropyThreads];
  const int row = blockIdx.x;
  const int bat = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t r = static_cast<size_t>(bat) * p + row;
  if (!mask[r]) {
    if (tid == 0) hx[r] = 0.f;
    return;
  }
  const int nvb = valid_count(nv, bat, n);
  const float* xr = x + r * n;
  float s1 = 0.f, s2 = 0.f;
  for (int base = 0; base < nvb; base += kBlockN) {
    const int w = min(kBlockN, nvb - base);
    float c1 = 0.f, c2 = 0.f;
    for (int k = tid; k < w; k += kEntropyThreads) {
      const float u = xr[base + k];
      c1 += log_cosh(u);
      c2 += u_exp(u);
    }
    s1 += c1;
    s2 += c2;
  }
  red[tid] = s1;
  red[kEntropyThreads + tid] = s2;
  __syncthreads();
  if (tid == 0) {
    float a1 = 0.f, a2 = 0.f;
    for (int l = 0; l < kEntropyThreads; ++l) {
      a1 += red[l];
      a2 += red[kEntropyThreads + l];
    }
    const float dn = denominator(nv, bat, n);
    hx[r] = entropy(a1 / dn, a2 / dn);
  }
}

__global__ void __launch_bounds__(1024)
fused_tri_tiles(const float* __restrict__ x, const float* __restrict__ c,
                const unsigned char* __restrict__ mask, const int* __restrict__ nv,
                const float* __restrict__ hx, const int* __restrict__ imap,
                const int* __restrict__ jmap, float* __restrict__ slots, int p,
                int n, int b, int nt, int lanes) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int bat = blockIdx.y;
  const int bi = imap[t];
  const int bj = jmap[t];
  const bool diag = bi == bj;
  const int npair = b * b;
  const int tid = threadIdx.x;
  const int pair = tid % npair;
  const int lane = tid / npair;
  // A diagonal tile computes each in-block pair a < q once, in the first
  // b (b - 1) / 2 pair slots (whole warps past them stay idle in the sweep),
  // and credits min(0, I)^2 to row a and min(0, -I)^2 to row q: the bits
  // that its (a, q) and (q, a) elements would give, at half the work.
  const int ntri = b * (b - 1) / 2;
  const bool active = !diag || pair < ntri;
  int a = pair / b;
  int q = pair % b;
  if (diag) {
    int t = active ? pair : 0;
    a = 0;
    while (t >= b - 1 - a) {
      t -= b - 1 - a;
      ++a;
    }
    q = a + 1 + t;
  }
  const int row_i = bi * b + a;
  const int row_j = bj * b + q;
  const unsigned char* mb = mask + static_cast<size_t>(bat) * p;
  // Slot (r, m) holds row block r's partial scores from its tile with block m.
  float* slot_ij = slots + ((static_cast<size_t>(bat) * nt + bi) * nt + bj) * b;
  float* slot_ji = slots + ((static_cast<size_t>(bat) * nt + bj) * nt + bi) * b;

  // The live-tile rule: a live pair needs a live row in each block, and two
  // distinct live rows in a diagonal tile. The test is uniform over the block.
  int live_i = 0, live_j = 0;
  for (int r = 0; r < b; ++r) {
    live_i += bi * b + r < p && mb[bi * b + r];
    live_j += bj * b + r < p && mb[bj * b + r];
  }
  if (diag ? live_i < 2 : (live_i == 0 || live_j == 0)) {
    if (tid < b) {
      slot_ij[tid] = 0.f;
    } else if (!diag && tid < 2 * b) {
      slot_ji[tid - b] = 0.f;
    }
    return;
  }

  const bool in_range = row_i < p && row_j < p;
  const bool pm = active && in_range && mb[row_i] && mb[row_j];
  const float* cb = c + static_cast<size_t>(bat) * p * p;
  const float cf = in_range ? cb[static_cast<size_t>(row_i) * p + row_j] : 0.f;
  const float cr = in_range && diag ? cb[static_cast<size_t>(row_j) * p + row_i] : cf;
  float v = __fsub_rn(1.f, __fmul_rn(cf, cf));
  v = v < kVarEps ? kVarEps : v;  // clamp that keeps NaN
  const float inv_f = 1.f / sqrtf(v);
  v = __fsub_rn(1.f, __fmul_rn(cr, cr));
  v = v < kVarEps ? kVarEps : v;
  const float inv_r = 1.f / sqrtf(v);

  // Staging: rows 0..b-1 of a buffer are block i's, b..2b-1 block j's (a
  // diagonal tile stages its b rows once). Two buffers of 2*b*kLd floats.
  const int nvb = valid_count(nv, bat, n);
  const float* xb = x + static_cast<size_t>(bat) * p * n;
  const int srows = diag ? b : 2 * b;
  const int buf_floats = 2 * b * kLd;
  auto stage = [&](int s0, int buf) {
    const int w = min(kStage, nvb - s0);
    float* dst0 = smem + buf * buf_floats;
    for (int e = tid; e < srows * kVecs; e += blockDim.x) {
      const int r = e / kVecs;
      const int k = (e % kVecs) * 4;
      const int g = r < b ? bi * b + r : bj * b + (r - b);
      if (g >= p || k >= w) continue;
      const float* row = xb + static_cast<size_t>(g) * n;
      const int m = min(4, w - k);
      float* dst = dst0 + r * kLd + k;
      if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        cp_async16(dst, row + s0 + k, 4 * m);
      } else {
        for (int h = 0; h < m; ++h) cp_async4(dst + h, row + s0 + k + h);
      }
    }
    cp_async_commit();
  };

  float s1f = 0.f, s2f = 0.f, s1r = 0.f, s2r = 0.f;
  // Chunk-local sums, then one add per chunk: two-level summation keeps the
  // f32 rounding of a long sample sweep near that of a tree sum.
  float c1f = 0.f, c2f = 0.f, c1r = 0.f, c2r = 0.f;
  int kk = lane;  // this thread's next sample, counted from its chunk's start
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
    const float* sx = smem + (s & 1) * buf_floats;
    const int s0 = s * kStage;
    const int off = s0 % kBlockN;  // this sub-chunk's start within its chunk
    const int cend = min(s0 + kStage, nvb) - (s0 - off);
    if (active) {  // kk >= off here: the last sub-chunk ended at off
      const float* xi_at = sx + a * kLd + (kk - off);
      const float* xj_at = sx + (diag ? q : b + q) * kLd + (kk - off);
      for (; kk < cend; kk += lanes, xi_at += lanes, xj_at += lanes) {
        const float xi = *xi_at;
        const float xj = *xj_at;
        const float uf = __fmul_rn(__fsub_rn(xi, __fmul_rn(cf, xj)), inv_f);
        const float ur = __fmul_rn(__fsub_rn(xj, __fmul_rn(cr, xi)), inv_r);
        c1f += log_cosh(uf);
        c2f += u_exp(uf);
        c1r += log_cosh(ur);
        c2r += u_exp(ur);
      }
    }
    if (off + kStage == kBlockN || s + 1 == nsub) {  // end of a chunk
      s1f += c1f;
      s2f += c2f;
      s1r += c1r;
      s2r += c2r;
      c1f = c2f = c1r = c2r = 0.f;
      kk = lane;
    }
    __syncthreads();  // the next iteration stages into this buffer
  }

  // Lane reduction in a fixed order, reusing the staging buffer.
  const int P = npair * lanes;
  smem[0 * P + lane * npair + pair] = s1f;
  smem[1 * P + lane * npair + pair] = s2f;
  smem[2 * P + lane * npair + pair] = s1r;
  smem[3 * P + lane * npair + pair] = s2r;
  __syncthreads();
  float* crf = smem + 4 * P;
  float* crr = crf + npair;
  if (lane == 0 && active) {
    float a1f = 0.f, a2f = 0.f, a1r = 0.f, a2r = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a1f += smem[0 * P + l * npair + pair];
      a2f += smem[1 * P + l * npair + pair];
      a1r += smem[2 * P + l * npair + pair];
      a2r += smem[3 * P + l * npair + pair];
    }
    const float dn = denominator(nv, bat, n);
    const float hr_f = entropy(a1f / dn, a2f / dn);
    const float hr_r = entropy(a1r / dn, a2r / dn);
    const float* hxb = hx + static_cast<size_t>(bat) * p;
    const float hi = row_i < p ? hxb[row_i] : 0.f;
    const float hj = row_j < p ? hxb[row_j] : 0.f;
    const float stat = (hj - hi) + (hr_f - hr_r);
    if (diag) {  // both credits go to the tile's own rows
      crf[a * b + q] = pm ? neg_sq(stat) : 0.f;
      crf[q * b + a] = pm ? neg_sq(-stat) : 0.f;
    } else {
      crf[pair] = pm ? neg_sq(stat) : 0.f;
      crr[pair] = pm ? neg_sq(-stat) : 0.f;
    }
  } else if (lane == 0 && pair - ntri < b) {  // a diagonal tile's (k, k)
    crf[(pair - ntri) * (b + 1)] = 0.f;
  }
  __syncthreads();
  if (tid < b) {
    float s = 0.f;
    for (int k = 0; k < b; ++k) s += crf[tid * b + k];
    slot_ij[tid] = s;
  } else if (!diag && tid < 2 * b) {
    const int k0 = tid - b;
    float s = 0.f;
    for (int r = 0; r < b; ++r) s += crr[r * b + k0];
    slot_ji[k0] = s;
  }
}

// Row e of row block r: its diagonal tile's partial plus the sum of its
// partials with the other row blocks m in ascending m (the column credits of
// tiles (m, r), m < r, then the row credits of tiles (r, m), m > r).
__global__ void fused_tri_reduce(const float* __restrict__ slots,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ out, int p, int b, int nt) {
  const int bat = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p) return;
  const int r = e / b;
  const int k = e - r * b;
  const float* sr = slots + (static_cast<size_t>(bat) * nt + r) * nt * b + k;
  float acc = 0.f;
  for (int m = 0; m < nt; ++m) {
    if (m != r) acc += sr[static_cast<size_t>(m) * b];
  }
  const size_t o = static_cast<size_t>(bat) * p + e;
  out[o] = mask[o] ? sr[static_cast<size_t>(r) * b] + acc : INFINITY;
}

// The sample loop's device functions at n points u: exp(-2|u|) (libdevice
// expf), log1p_unit of it, log_cosh(u) and u_exp(u), for chip_smoke.py's
// [fused_math_probe] against float64.
__global__ void math_probe(const float* __restrict__ u, float* __restrict__ out,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float e = expf(-2.f * fabsf(u[i]));
  out[i] = e;
  out[n + i] = log1p_unit(e);
  out[2 * n + i] = log_cosh(u[i]);
  out[3 * n + i] = u_exp(u[i]);
}

}  // namespace

extern "C" int fused_math_probe(const void* u, void* out, int n, void* stream) {
  math_probe<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_score_launch(const void* x, const void* c, const void* mask,
                                  const void* nv, const void* imap, const void* jmap,
                                  void* scratch, void* out, int batch, int p, int n,
                                  int b, int nt, int lanes, int smem_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hx = static_cast<float*>(scratch);
  float* slots = hx + static_cast<size_t>(batch) * p;
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const int* counts = static_cast<const int*>(nv);
  row_entropies<<<dim3(p, batch), kEntropyThreads, 0, st>>>(
      static_cast<const float*>(x), mk, counts, hx, p, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_tri_tiles,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = nt * (nt + 1) / 2;
  fused_tri_tiles<<<dim3(tiles, batch), b * b * lanes, smem_bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(c), mk, counts, hx,
      static_cast<const int*>(imap), static_cast<const int*>(jmap), slots, p, n, b, nt,
      lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  fused_tri_reduce<<<dim3((p + 127) / 128, batch), 128, 0, st>>>(
      slots, mk, static_cast<float*>(out), p, b, nt);
  return static_cast<int>(cudaGetLastError());
}

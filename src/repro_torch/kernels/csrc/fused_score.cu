// Fused triangular score sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_tri_kernel` in src/repro/kernels/fused_score.py
// (entries `fused_score_vector` and, over a bucket of datasets on a (T, B)
// grid, `fused_score_batch`). It computes the same function, not the same
// block schedule:
//
//   for every unordered off-diagonal pair of row blocks (i < j) of size b,
//   stream the n samples of the two blocks and accumulate, for every row pair
//   (a, q), four raw sums: sum log cosh u and sum u exp(-u^2/2) for the
//   forward residual u_f = (x_a - c_aq x_q) / sqrt(1 - c_aq^2) and the reverse
//   residual u_r = (x_q - c_aq x_a) / sqrt(1 - c_aq^2). Divide by the valid
//   count, take the Hyvarinen entropies, form I = (H_q - H_a) + (HR_f - HR_r)
//   and credit min(0, I)^2 to row a and min(0, -I)^2 to row q (masked by
//   select, never by multiply: dead rows may hold non-finite data).
//
// What bounds it on the card: every element of the (b, b, n) pair-sample cube
// costs three transcendentals per direction (exp, log1p, exp), so the sweep
// is bound by the special-function units and the FP32 pipes that run the
// libdevice expansions, not by memory: each tile reads 2*b*n floats and does
// ~6*b*b*n transcendentals. The design therefore keeps every sample load in
// shared memory (a b-row slice of x_i and of x_j, reused by b threads each),
// keeps the four sums in registers, and spreads one tile over b*b*lanes
// threads so that even the small late stages of the causal-order scan put
// enough warps on the SMs.
//
// Determinism: the TPU kernel adds every tile into one resident output in
// grid order. Blocks here run concurrently, so the tile kernel writes per-tile
// partial row and column sums to a scratch buffer and a second kernel adds,
// for each row, its partials in ascending tile order. No atomics: the f32 sum
// order, and so the causal order, is the same on every run.
//
// Contract (see fused_score.py): x (B, p, n), c (B, p, p) float32; hx, mask,
// s_diag (B, p_pad) with p_pad = nt * b; den (B,) valid sample counts, or
// null for all n samples (float32 of n, as the plain version divides); imap,
// jmap (T,) int64 tile maps with T = nt (nt - 1) / 2 in row-major order;
// partial (B, T, 2, b) scratch; out (B, p) scores (+inf on dead rows). Any p
// and n: rows >= p read as 0 and are masked, the last sample chunk is ragged.
// Zero-padded sample columns add exactly 0 to both sums (log cosh 0 is taken
// as exactly 0), so n_valid only changes the divide. Launches on the given
// stream, does not synchronize, allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kVarEps = 1e-12f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kK1 = 79.047f;
constexpr float kK2 = 7.4129f;
constexpr float kBeta = 0.37457f;
constexpr float kHGauss = 1.4189385332046727f;  // (1 + log 2 pi) / 2

__device__ __forceinline__ float log_cosh(float u) {
  const float a = fabsf(u);
  return a == 0.f ? 0.f : a + log1pf(expf(-2.f * a)) - kLn2;
}

__device__ __forceinline__ float u_exp(float u) {
  return u * expf(-0.5f * (u * u));
}

__device__ __forceinline__ float entropy(float m1, float m2) {
  const float d = m1 - kBeta;
  return kHGauss - kK1 * (d * d) - kK2 * (m2 * m2);
}

// min(0, v)^2, NaN-propagating like the plain version's clamp.
__device__ __forceinline__ float neg_sq(float v) {
  const float m = v > 0.f ? 0.f : v;
  return m * m;
}

__global__ void fused_tri_tiles(const float* __restrict__ x,
                                const float* __restrict__ c,
                                const float* __restrict__ hx,
                                const unsigned char* __restrict__ mask,
                                const float* __restrict__ den,
                                const long long* __restrict__ imap,
                                const long long* __restrict__ jmap,
                                float* __restrict__ partial,
                                int p, int n, int p_pad, int b, int T,
                                int block_n, int lanes) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int bat = blockIdx.y;
  const int bi = static_cast<int>(imap[t]);
  const int bj = static_cast<int>(jmap[t]);
  const int npair = b * b;
  const int tid = threadIdx.x;
  const int pair = tid % npair;
  const int lane = tid / npair;
  const int a = pair / b;
  const int q = pair % b;
  const int row_i = bi * b + a;
  const int row_j = bj * b + q;
  const float* xb = x + static_cast<size_t>(bat) * p * n;
  const float* cb = c + static_cast<size_t>(bat) * p * p;

  const float cij =
      (row_i < p && row_j < p) ? cb[static_cast<size_t>(row_i) * p + row_j] : 0.f;
  float v = __fsub_rn(1.f, __fmul_rn(cij, cij));
  v = v < kVarEps ? kVarEps : v;  // clamp that keeps NaN
  const float inv = 1.f / sqrtf(v);

  const int ld = block_n + 1;  // odd stride: rows land in distinct banks
  float* sxi = smem;
  float* sxj = smem + b * ld;
  float s1f = 0.f, s2f = 0.f, s1r = 0.f, s2r = 0.f;
  for (int base = 0; base < n; base += block_n) {
    const int w = min(block_n, n - base);
    __syncthreads();
    for (int e = tid; e < b * w; e += blockDim.x) {
      const int r = e / w;
      const int k = e - r * w;
      const int gi = bi * b + r;
      const int gj = bj * b + r;
      sxi[r * ld + k] = gi < p ? xb[static_cast<size_t>(gi) * n + base + k] : 0.f;
      sxj[r * ld + k] = gj < p ? xb[static_cast<size_t>(gj) * n + base + k] : 0.f;
    }
    __syncthreads();
    const float* xi_row = sxi + a * ld;
    const float* xj_row = sxj + q * ld;
    // Chunk-local sums, then one add per chunk: two-level summation keeps
    // the f32 rounding of a long sample sweep near that of a tree sum.
    float c1f = 0.f, c2f = 0.f, c1r = 0.f, c2r = 0.f;
    for (int k = lane; k < w; k += lanes) {
      const float xi = xi_row[k];
      const float xj = xj_row[k];
      const float uf = __fmul_rn(__fsub_rn(xi, __fmul_rn(cij, xj)), inv);
      const float ur = __fmul_rn(__fsub_rn(xj, __fmul_rn(cij, xi)), inv);
      c1f += log_cosh(uf);
      c2f += u_exp(uf);
      c1r += log_cosh(ur);
      c2r += u_exp(ur);
    }
    s1f += c1f;
    s2f += c2f;
    s1r += c1r;
    s2r += c2r;
  }

  // Lane reduction in a fixed order, reusing the staging buffer.
  const int P = npair * lanes;
  __syncthreads();
  smem[0 * P + lane * npair + pair] = s1f;
  smem[1 * P + lane * npair + pair] = s2f;
  smem[2 * P + lane * npair + pair] = s1r;
  smem[3 * P + lane * npair + pair] = s2r;
  __syncthreads();
  float* cf = smem + 4 * P;
  float* cr = cf + npair;
  if (lane == 0) {
    float a1f = 0.f, a2f = 0.f, a1r = 0.f, a2r = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a1f += smem[0 * P + l * npair + pair];
      a2f += smem[1 * P + l * npair + pair];
      a1r += smem[2 * P + l * npair + pair];
      a2r += smem[3 * P + l * npair + pair];
    }
    const float dn = den != nullptr ? den[bat] : static_cast<float>(n);
    const float hr_f = entropy(a1f / dn, a2f / dn);
    const float hr_r = entropy(a1r / dn, a2r / dn);
    const float* hxb = hx + static_cast<size_t>(bat) * p_pad;
    const unsigned char* mb = mask + static_cast<size_t>(bat) * p_pad;
    const float stat = (hxb[row_j] - hxb[row_i]) + (hr_f - hr_r);
    const bool pm = mb[row_i] && mb[row_j];
    cf[pair] = pm ? neg_sq(stat) : 0.f;
    cr[pair] = pm ? neg_sq(-stat) : 0.f;
  }
  __syncthreads();
  float* out = partial + (static_cast<size_t>(bat) * T + t) * 2 * b;
  if (tid < b) {
    float s = 0.f;
    for (int k = 0; k < b; ++k) s += cf[tid * b + k];
    out[tid] = s;
  } else if (tid < 2 * b) {
    const int k0 = tid - b;
    float s = 0.f;
    for (int r = 0; r < b; ++r) s += cr[r * b + k0];
    out[b + k0] = s;
  }
}

// Row block r's tiles in ascending t: first (i, r) for i < r, at
// t = start(i) + r - i - 1, then (r, j) for j > r, at start(r) + j - r - 1,
// where start(i) = i * nt - i * (i + 1) / 2 is the first tile of row block i.
__global__ void fused_tri_reduce(const float* __restrict__ partial,
                                 const float* __restrict__ s_diag,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ out,
                                 int p, int p_pad, int b, int nt) {
  const int bat = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p) return;
  const int T = nt * (nt - 1) / 2;
  const int r = e / b;
  const int k = e - r * b;
  const float* pt = partial + static_cast<size_t>(bat) * T * 2 * b;
  float acc = 0.f;
  for (int i = 0; i < r; ++i) {
    const int t = i * nt - i * (i + 1) / 2 + r - i - 1;
    acc += pt[static_cast<size_t>(t) * 2 * b + b + k];  // column credits
  }
  const int start = r * nt - r * (r + 1) / 2;
  for (int t = start; t < start + nt - 1 - r; ++t) {
    acc += pt[static_cast<size_t>(t) * 2 * b + k];  // row credits
  }
  const size_t o = static_cast<size_t>(bat) * p_pad + e;
  out[static_cast<size_t>(bat) * p + e] = mask[o] ? s_diag[o] + acc : INFINITY;
}

}  // namespace

extern "C" int fused_score_launch(const void* x, const void* c, const void* hx,
                                  const void* mask, const void* s_diag,
                                  const void* den, const void* imap,
                                  const void* jmap, void* partial, void* out,
                                  int batch, int p, int n, int p_pad, int b,
                                  int nt, int block_n, int lanes, int smem_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = nt * (nt - 1) / 2;
  if (T > 0) {
    if (smem_bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fused_tri_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dim3 grid(T, batch);
    fused_tri_tiles<<<grid, b * b * lanes, smem_bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(c),
        static_cast<const float*>(hx), static_cast<const unsigned char*>(mask),
        static_cast<const float*>(den), static_cast<const long long*>(imap),
        static_cast<const long long*>(jmap), static_cast<float*>(partial), p, n,
        p_pad, b, T, block_n, lanes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid2((p + 127) / 128, batch);
  fused_tri_reduce<<<grid2, 128, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(s_diag),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), p, p_pad,
      b, nt);
  return static_cast<int>(cudaGetLastError());
}

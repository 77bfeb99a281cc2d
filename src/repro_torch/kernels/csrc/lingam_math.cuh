// Device functions shared by the two score kernels, fused_score.cu (#1-#2)
// and pairwise_moments.cu (#3): the sample loop's math (log cosh u and
// u exp(-u^2/2), with the polynomial log1p_unit), the valid sample count of
// a dataset, and the cp.async staging helpers. Both kernels include it, so
// they compute every residual's integrands with the same instructions.
// _build.library_path hashes every header of csrc/ into each library's name:
// an edited header rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kVarEps = 1e-12f;
constexpr float kLn2 = 0.693147180559945309f;

// log1p(e) for e in [0, 1], the only arguments log_cosh gives it: e P(e)
// with P a degree-10 polynomial (float32 coefficients fitted to log1p(e)/e
// on [0, 1] for relative error), by Horner's rule in fused multiply-adds.
// Within 1.4 ulp of float64 log1p at every e = exp(-2|u|), u in [-60, 60]
// (tests/test_torch_fused_score.py emulates it on the CPU; chip_smoke.py
// [fused_math_probe] measures it on the card). It replaces libdevice's
// log1pf: 11 instructions where log1pf's range reduction and special cases
// took 27 and a branch, in each direction of the sample loop (SASS of the
// sm_90a build, 138 instructions per (pair, sample) with log1pf).
__device__ __forceinline__ float log1p_unit(float e) {
  float r = fmaf(0.002030261f, e, -0.013407634f);
  r = fmaf(r, e, 0.04147846f);
  r = fmaf(r, e, -0.082442045f);
  r = fmaf(r, e, 0.124184586f);
  r = fmaf(r, e, -0.16105703f);
  r = fmaf(r, e, 0.19890751f);
  r = fmaf(r, e, -0.24987271f);
  r = fmaf(r, e, 0.3333256f);
  r = fmaf(r, e, -0.49999982f);
  r = fmaf(r, e, 1.f);
  return e * r;
}

// log cosh u = |u| + log1p(exp(-2|u|)) - log 2. Exactly 0 at u = 0 with no
// select: expf(-0) is 1 and log1p_unit(1) rounds to kLn2 itself.
__device__ __forceinline__ float log_cosh(float u) {
  const float a = fabsf(u);
  return a + log1p_unit(expf(-2.f * a)) - kLn2;
}

__device__ __forceinline__ float u_exp(float u) {
  return u * expf(-0.5f * (u * u));
}

// Samples the loops visit: the dataset's valid count, within [0, n].
__device__ __forceinline__ int valid_count(const int* nv, int bat, int n) {
  if (nv == nullptr) return n;
  const int v = nv[bat];
  return v < 0 ? 0 : (v > n ? n : v);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace

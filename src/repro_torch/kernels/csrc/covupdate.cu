// Rank-1 iteration update kernels for Hopper (sm_90a): paper Algorithms 7
// and 8, Eq. (10)/(11).
//
// Replace the TPU kernels of src/repro/kernels/covupdate.py:
//
//   update_data (`_update_data_kernel`, :21; call :56), one dataset (p, n):
//     out[i, k] = (x[i, k] - b[i] * x_root[k]) * rsqrt(max(1 - b[i]^2, 1e-12))
//   update_cov (`_update_cov_kernel`, :29; call :86), (p, p):
//     out[i, j] = (c[i, j] - b[i] * b[j]) * inv[i] * inv[j], and exactly 1 on
//     the diagonal, with inv = rsqrt(max(1 - b^2, 1e-12)).
//
// The inverse scale is 1 / sqrtf (correctly rounded square root, then a
// correctly rounded divide) and every product and difference is rounded on
// its own (no FMA contraction), in the order of the TPU kernel's
// expressions, as the plain torch versions round them.
//
// What bounds them on the card: memory. Each element is read once and
// written once with ~5 FP32 operations (update_data moves 8 p n bytes:
// 8.2 MB at p=512, n=2000, ~2.4 us at 3.35 TB/s), so at the paper's sizes a
// launch's fixed cost is of the same order as the transfer. One block per
// (row, 1024-column chunk), each thread on neighbouring columns (coalesced),
// b[i] and its inverse scale taken once per thread; any p and n, no padding
// copies (the TPU wrapper padded to its (8, 512) and (8, 128) blocks).
//
// Contract (see covupdate.py): float32 contiguous tensors, p, n >= 1.
// Launches on the given stream, does not synchronize, allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4 * kThreads;  // columns per block
constexpr float kVarEps = 1e-12f;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float inv_scale(float b) {
  float v = __fsub_rn(1.f, __fmul_rn(b, b));
  v = v < kVarEps ? kVarEps : v;  // clamp that keeps NaN
  return 1.f / sqrtf(v);
}

__global__ void update_data_rows(const float* __restrict__ x,
                                 const float* __restrict__ xr,
                                 const float* __restrict__ b,
                                 float* __restrict__ out, int p, int n) {
  for (int i = blockIdx.y; i < p; i += gridDim.y) {
    const float bi = b[i];
    const float inv = inv_scale(bi);
    const size_t row = static_cast<size_t>(i) * n;
    const int k0 = blockIdx.x * kCols;
    for (int k = k0 + threadIdx.x; k < min(n, k0 + kCols); k += kThreads) {
      out[row + k] = __fmul_rn(__fsub_rn(x[row + k], __fmul_rn(bi, xr[k])), inv);
    }
  }
}

__global__ void update_cov_rows(const float* __restrict__ c,
                                const float* __restrict__ b,
                                float* __restrict__ out, int p) {
  for (int i = blockIdx.y; i < p; i += gridDim.y) {
    const float bi = b[i];
    const float inv_i = inv_scale(bi);
    const size_t row = static_cast<size_t>(i) * p;
    const int j0 = blockIdx.x * kCols;
    for (int j = j0 + threadIdx.x; j < min(p, j0 + kCols); j += kThreads) {
      const float bj = b[j];
      const float v = __fmul_rn(
          __fmul_rn(__fsub_rn(c[row + j], __fmul_rn(bi, bj)), inv_i), inv_scale(bj));
      out[row + j] = i == j ? 1.f : v;
    }
  }
}

dim3 grid_of(int rows, int cols) {
  return dim3((cols + kCols - 1) / kCols, rows < kMaxGridY ? rows : kMaxGridY);
}

}  // namespace

extern "C" int update_data_launch(const void* x, const void* xr, const void* b,
                                  void* out, int p, int n, void* stream) {
  if (p < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  update_data_rows<<<grid_of(p, n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(xr),
      static_cast<const float*>(b), static_cast<float*>(out), p, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int update_cov_launch(const void* c, const void* b, void* out,
                                 int p, void* stream) {
  if (p < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  update_cov_rows<<<grid_of(p, p), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const float*>(b),
      static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// Mamba2 SSD decode-step kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_decode_kernel` in
// src/repro/kernels/ssd_decode.py:27 (entry `ssd_decode`, call :60). It
// computes the same function, per batch row b and head h:
//
//   state'[p, n] = state[p, n] * exp(dt * A) + (dt * x[p]) * B[n]
//   y[p]         = sum_n state'[p, n] * C[n] + D * x[p]
//
// with state (B, H, P, N), x (B, H, P), dt (B, H), B and C (B, N), A and D
// (H,), float32 throughout. It returns y and a fresh new state: the state
// is not updated in place, so the caller's old cache stays valid (a decode
// step can be replayed from it), at the price of a second (B, H, P, N)
// buffer while the step runs.
//
// What bounds it on the card: memory. Each state element is read once and
// written once and costs 4 FP32 operations, so a step moves
// 2 * 4 * B * H * P * N bytes (8.4 MB at B=4 and Mamba2-370M's H=32, P=64,
// N=128: ~2.5 us at 3.35 TB/s). So little data per launch reaches the
// card's bandwidth only with many bytes in flight at once (~15 KB per SM at
// ~0.6 us of memory latency), and the design is about that:
//
// - a grid over (b * H + h, P-slices of kRowsPerBlock rows): 512 blocks of
//   4 warps at Mamba2-370M's decode shape, several resident on every SM;
// - each warp keeps kRowsPerWarp state rows in flight: every lane starts
//   its 16-byte loads of all of its rows (and of B and C) before it uses
//   the first, and stores 16 bytes at a time;
// - exp(dt * A) is taken once per warp, not per element;
// - rows whose start is not 16-byte aligned (N not a multiple of 4, or a
//   view at an odd offset) take a scalar path over the same columns.
//
// Determinism: every product and sum is rounded on its own (no FMA
// contraction), as the plain torch version rounds them, so the new state is
// bit-equal to it. y's N-reduction runs in a fixed order that depends only
// on N: lane l adds the columns 4l..4l+3, 128+4l.., ... in ascending order,
// on both paths, then a warp butterfly adds the lanes; no atomics. So row b
// of a batched launch is bit-identical to a one-row launch (whose views may
// take the other path), for any H (the TPU wrapper needed H to be a
// multiple of its head block).
//
// Contract (see ssd_decode.py): every tensor float32 and contiguous; batch,
// heads, P and N >= 1. Launches on the given stream, does not synchronize,
// allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // the P-slice of one block
constexpr int kCols = 4 * 32;  // columns a warp covers per pass

// Columns n..n+3 of `row` into v, for n < ndim; columns at or past ndim
// read as 0 (the scalar path's ragged last pass; never stored or summed).
template <bool kVec>
__device__ __forceinline__ void load_cols(const float* row, int n, int ndim, float (&v)[4]) {
  if (kVec) {  // ndim % 4 == 0: all four columns are in range
    const float4 t = *reinterpret_cast<const float4*>(row + n);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = n + k < ndim ? row[n + k] : 0.f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
ssd_decode_heads(const float* __restrict__ state, const float* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* __restrict__ a,
                 const float* __restrict__ d, float* __restrict__ new_state,
                 float* __restrict__ y, int heads, int pdim, int ndim) {
  const int bh = blockIdx.x;  // b * heads + h
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = blockIdx.y * kRowsPerBlock + warp * kRowsPerWarp;
  if (p0 >= pdim) return;  // the whole warp: no barrier below
  const int rows = min(kRowsPerWarp, pdim - p0);

  const float* brow = bm + static_cast<size_t>(b) * ndim;
  const float* crow = cm + static_cast<size_t>(b) * ndim;
  const size_t tile = (static_cast<size_t>(bh) * pdim + p0) * ndim;
  const float dth = dt[bh];
  const float decay = expf(__fmul_rn(dth, a[h]));
  const float dh = d[h];
  float xp[kRowsPerWarp], dtx[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    xp[r] = r < rows ? x[static_cast<size_t>(bh) * pdim + p0 + r] : 0.f;
    dtx[r] = __fmul_rn(dth, xp[r]);
    acc[r] = 0.f;
  }

  for (int n0 = 0; n0 < ndim; n0 += kCols) {
    const int n = n0 + 4 * lane;
    if (n >= ndim) break;  // this lane's columns of every later pass are past N too
    float bv[4], cv[4], sv[kRowsPerWarp][4];
    load_cols<kVec>(brow, n, ndim, bv);
    load_cols<kVec>(crow, n, ndim, cv);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r < rows) load_cols<kVec>(state + tile + static_cast<size_t>(r) * ndim, n, ndim, sv[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r >= rows) continue;
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out[k] = __fadd_rn(__fmul_rn(sv[r][k], decay), __fmul_rn(dtx[r], bv[k]));
        if (kVec || n + k < ndim) acc[r] = __fadd_rn(acc[r], __fmul_rn(out[k], cv[k]));
      }
      float* dst = new_state + tile + static_cast<size_t>(r) * ndim + n;
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (n + k < ndim) dst[k] = out[k];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = acc[r];
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    }
    if (lane == 0 && r < rows) {
      y[static_cast<size_t>(bh) * pdim + p0 + r] = __fadd_rn(s, __fmul_rn(xp[r], dh));
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int ssd_decode_launch(const void* state, const void* x,
                                 const void* dt, const void* bm,
                                 const void* cm, const void* a, const void* d,
                                 void* new_state, void* y, int batch,
                                 int heads, int pdim, int ndim, void* stream) {
  if (batch < 1 || heads < 1 || pdim < 1 || ndim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(batch * heads, (pdim + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ndim % 4 == 0 && aligned16(state) && aligned16(new_state) &&
                   aligned16(bm) && aligned16(cm);
  auto kernel = vec ? ssd_decode_heads<true> : ssd_decode_heads<false>;
  kernel<<<grid, kWarps * 32, 0, st>>>(
      static_cast<const float*>(state), static_cast<const float*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(a),
      static_cast<const float*>(d), static_cast<float*>(new_state),
      static_cast<float*>(y), heads, pdim, ndim);
  return static_cast<int>(cudaGetLastError());
}

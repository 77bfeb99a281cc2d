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
// N=128: ~2.5 us at 3.35 TB/s). At that size a launch's fixed cost is of
// the same order. The design keeps the traffic at that minimum: one block
// per (batch row, head) streams its (P, N) tile once, a warp per state row
// with neighbouring lanes on neighbouring n (coalesced 128-byte accesses),
// B and C read through the cache, exp(dt * A) computed once per block.
//
// Determinism: every product and sum is rounded on its own (no FMA
// contraction), as the plain torch version rounds them; y's N-reduction runs
// in a fixed order (each lane's strided sum, then a warp butterfly), with no
// atomics. A block's work depends on its own (b, h) only, so row b of a
// batched launch is bit-identical to a one-row launch, for any H (the TPU
// wrapper needed H to be a multiple of its head block).
//
// Contract (see ssd_decode.py): every tensor float32 and contiguous; batch,
// heads, P and N >= 1. Launches on the given stream, does not synchronize,
// allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void ssd_decode_heads(const float* __restrict__ state,
                                 const float* __restrict__ x,
                                 const float* __restrict__ dt,
                                 const float* __restrict__ bm,
                                 const float* __restrict__ cm,
                                 const float* __restrict__ a,
                                 const float* __restrict__ d,
                                 float* __restrict__ new_state,
                                 float* __restrict__ y, int heads, int pdim,
                                 int ndim) {
  const int bh = blockIdx.x;  // b * heads + h
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;

  const float dth = dt[bh];
  const float decay = expf(__fmul_rn(dth, a[h]));
  const float dh = d[h];
  const float* brow = bm + static_cast<size_t>(b) * ndim;
  const float* crow = cm + static_cast<size_t>(b) * ndim;
  const float* xh = x + static_cast<size_t>(bh) * pdim;
  const size_t tile = static_cast<size_t>(bh) * pdim * ndim;

  for (int p = warp; p < pdim; p += warps) {
    const float xp = xh[p];
    const float dtx = __fmul_rn(dth, xp);
    const float* src = state + tile + static_cast<size_t>(p) * ndim;
    float* dst = new_state + tile + static_cast<size_t>(p) * ndim;
    float acc = 0.f;
    for (int n = lane; n < ndim; n += 32) {
      const float s = __fadd_rn(__fmul_rn(src[n], decay), __fmul_rn(dtx, brow[n]));
      dst[n] = s;
      acc = __fadd_rn(acc, __fmul_rn(s, crow[n]));
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) {
      y[static_cast<size_t>(bh) * pdim + p] = __fadd_rn(acc, __fmul_rn(xp, dh));
    }
  }
}

}  // namespace

extern "C" int ssd_decode_launch(const void* state, const void* x,
                                 const void* dt, const void* bm,
                                 const void* cm, const void* a, const void* d,
                                 void* new_state, void* y, int batch,
                                 int heads, int pdim, int ndim, void* stream) {
  if (batch < 1 || heads < 1 || pdim < 1 || ndim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_decode_heads<<<batch * heads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(a),
      static_cast<const float*>(d), static_cast<float*>(new_state),
      static_cast<float*>(y), heads, pdim, ndim);
  return static_cast<int>(cudaGetLastError());
}

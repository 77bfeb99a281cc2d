"""Fused triangular score sweep: the CUDA kernel's wrappers and plain versions.

Replaces the TPU kernel ``_fused_tri_kernel`` of
``src/repro/kernels/fused_score.py`` through both of its entries:
``fused_score_vector`` (one dataset) and ``fused_score_batch`` (a bucket of
datasets, one valid sample count per dataset), and the jnp prologue its
wrapper runs (row entropies, diagonal tiles). The CUDA source,
``csrc/fused_score.cu``, runs three kernels from one call: the row
entropies; the sweep, which visits every pair of row blocks (i <= j) once,
streams each dataset's valid samples through shared memory, keeps the four
raw moment sums per row pair in registers, finalizes the entropies, the
antisymmetric stat and the messaging credits in the block, and writes
per-tile partial scores; and an ordered reduce that adds each row's partials
(its diagonal tile's, then the others in ascending row-block order; no
atomics, so the f32 sum order is fixed).

Bound on the card: three transcendentals (exp, log1p, exp) per direction for
every (pair, sample), two libdevice ``expf`` and a polynomial ``log1p``: 64
FP32 instructions (of 83 in all) and 4 MUFU per (pair, sample), so the sweep
is bound by the FP32 pipe, then by the special-function units, not by
memory. The sweep skips what no score needs: each dataset's sample loop
stops at its own valid count, and a tile with no live pair returns before it
stages a sample.

The wrapper checks its inputs, turns the valid counts into a (B,) int32
device tensor and makes one ctypes call: the kernels read the caller's
``xn``, ``c`` and ``mask`` as they are. ``core.pairwise.fused_layout`` is
only the plain version's prologue. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernels or raises; on a fake CUDA
tensor (the dry run's) it allocates what the launch writes and notes its
``flops`` (``kernels/_fake.py``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core.pairwise import fused_scores
from repro_torch.kernels import _fake

#: Kernel launches since the last reset, one per call on the card:
#: ``LAUNCHES`` of ``fused_score_vector``, ``BATCH_LAUNCHES`` of
#: ``fused_score_batch``. Concurrent dispatcher threads count under a lock.
LAUNCHES = 0
BATCH_LAUNCHES = 0
_count_mu = threading.Lock()

_MAX_BLOCK = 32  # b * b pairs must fit one thread block
#: Samples per summation chunk, counted from sample 0 (``kBlockN`` of the
#: CUDA source): each thread adds its samples of a chunk, then the chunk sum.
BLOCK_N = 512
#: Shared row stride in floats of the CUDA source's staging buffers
#: (``kLd``: 128 staged samples and 4 of padding; two buffers of 2 b rows).
STAGE_LD = 132
_FILL_THREADS = 132 * 2048  # resident threads of a full H100
#: FP32 arithmetic instructions per (unordered pair, sample) of the sweep's
#: tile loop and per (row, sample) of the row-entropy loop, as
#: ``cuobjdump -sass`` of the built library counts them (``chip_smoke.py``'s
#: ``[fused_sass]``: 64 of 83 and 29 of 36.5 instructions).
FP32_PER_PAIR_SAMPLE = 64
FP32_PER_ROW_SAMPLE = 29


def flops(p: int, n: int, batch: int = 1) -> float:
    """The FP32 operations of one call on ``batch`` datasets of (p, n),
    every pair and sample live: the sweep's and the row entropies' FP32
    instructions, one operation each (the issue rate the bound counts)."""
    return float(batch * n * (FP32_PER_PAIR_SAMPLE * p * (p - 1) // 2 + FP32_PER_ROW_SAMPLE * p))


def fused_score_vector_ref(xn, c, mask, *, block: int = 8, n_valid=None):
    """Plain version: the kernel's arithmetic as torch ops at the kernel's
    block (raw sums divided by the valid count, per-tile partials added in
    ascending tile order)."""
    return fused_scores(xn, c, mask, block=block, n_valid=n_valid)


#: Relative float32 error allowed on each entropy when the kernel and the
#: plain version sum the same n terms in different orders (~8 ulps).
ENTROPY_RTOL = 1e-6
#: Relative error allowed on each score on top of the propagated one.
SCORE_RTOL = 1e-5


def score_tolerance(s_ref, xn, c, mask, n_valid=None):
    """Per-row tolerance for a kernel score against its plain version.

    Each stat I_ij = (H_j - H_i) + (HR_ij - HR_ji) is a sum of four entropies,
    so its rounding error is dI_ij = ENTROPY_RTOL * (|H_i| + |H_j| + |HR_ij|
    + |HR_ji|), and S_i = sum_j min(0, I_ij)^2 moves by at most
    sum_j (2 |I_ij| dI_ij + dI_ij^2). The entropies and stats come from the
    square plain path on the same inputs. The bound is wide where a
    near-collinear pair (1 - c^2 at its floor) makes the entropies, and so
    I, huge and float32-noisy in every implementation. Where the stats are
    near the entropies' own rounding (Gaussian data at n=10000: S ~ 1e-9)
    it exceeds S itself, and a comparison under it tests nothing."""
    from repro_torch.core.pairwise import dense_scores, row_entropies

    _, stat, hr = dense_scores(xn, c, mask, n_valid=n_valid)
    h = row_entropies(xn, mask, n_valid=n_valid).abs()
    d_i = ENTROPY_RTOL * (h[:, None] + h[None, :] + hr.abs() + hr.abs().T)
    eye = torch.eye(xn.shape[0], dtype=torch.bool, device=xn.device)
    pm = mask[:, None] & mask[None, :] & ~eye
    slack = torch.where(pm, 2 * stat.abs() * d_i + d_i * d_i, 0.0).sum(dim=1)
    return SCORE_RTOL * s_ref.abs() + slack


def fused_score_batch_ref(xb, cb, maskb, *, block: int = 8, n_valid=None):
    """Plain version of the batched sweep: ``fused_score_vector_ref`` on each
    dataset with its own valid count, stacked to (B, p)."""
    return torch.stack([
        fused_scores(xb[i], cb[i], maskb[i], block=block,
                     n_valid=None if n_valid is None else n_valid[i])
        for i in range(xb.shape[0])])


def _check(xn, c, mask, block: int, batched: bool = False):
    lead = xn.shape[:1] if batched else ()
    want = "(B, p, n)" if batched else "(p, n)"
    if xn.ndim != 2 + batched or min(xn.shape) < 1:
        raise ValueError(f"xn must be {want} with p, n >= 1, got {tuple(xn.shape)}")
    p = xn.shape[-2]
    if tuple(c.shape) != (*lead, p, p) or tuple(mask.shape) != (*lead, p):
        raise ValueError(f"want c {(*lead, p, p)} and mask {(*lead, p)}, got "
                         f"{tuple(c.shape)} and {tuple(mask.shape)}")
    if xn.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"xn and c must be float32, got {xn.dtype} and {c.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if not (xn.device == c.device == mask.device):
        raise ValueError("xn, c and mask must be on one device")
    if not (xn.is_contiguous() and c.is_contiguous() and mask.is_contiguous()):
        raise ValueError("xn, c and mask must be contiguous")
    if not 1 <= block <= _MAX_BLOCK:
        raise ValueError(f"need 1 <= block <= {_MAX_BLOCK}, got block={block}")


def _valid_counts(n_valid, bsz: int, device):
    """The valid sample counts on the card as a (B,) int32 tensor, or
    ``None`` when every sample is valid (the kernels use n). A device tensor
    is cast on the device: no host synchronization."""
    if n_valid is None:
        return None
    nv = torch.as_tensor(n_valid, device=device).reshape(-1)
    return nv.to(torch.int32).expand(bsz).contiguous()


def _lanes(b: int, tiles: int) -> int:
    """Threads per row pair: 256-thread blocks, widened up to 1024 threads
    while the grid would leave the card's thread slots mostly empty."""
    npair = b * b
    lanes = max(1, 256 // npair, -(-2 * b // npair))
    while 2 * lanes * npair <= 1024 and tiles * lanes * npair < _FILL_THREADS:
        lanes *= 2
    return lanes


def _smem_bytes(b: int, lanes: int) -> int:
    """Dynamic shared memory of the tile kernel: the two staging buffers,
    or the lane reduction's sums and credits, whichever is larger."""
    return 4 * max(2 * 2 * b * STAGE_LD, 4 * b * b * lanes + 2 * b * b)


def fused_score_vector(xn, c, mask, *, block: int = 8, n_valid=None):
    """Messaging-folded score vector S via the fused triangular kernel.

    ``xn: (p, n)`` normalized rows, ``c: (p, p)`` correlations, both float32
    and contiguous, ``mask: (p,)`` bool live rows. Returns (p,) float32
    scores (+inf on dead rows). ``n_valid`` is the valid sample count of
    zero-padded data: the kernels stop there, so the scores are those of
    the unpadded data, bit for bit."""
    _check(xn, c, mask, block)
    if _fake.on_card(xn):
        _fake.note("fused_score", flops(*xn.shape))
        return _buffers(xn[None], block)[1][0]
    if xn.device.type == "cpu":
        return fused_score_vector_ref(xn, c, mask, block=block, n_valid=n_valid)
    if xn.device.type != "cuda":
        raise ValueError(f"fused_score_vector runs on cuda or cpu, not {xn.device}")
    return launch(xn, c, mask, _valid_counts(n_valid, 1, xn.device), block=block)


def fused_score_batch(xb, cb, maskb, *, block: int = 8, n_valid=None):
    """Score vectors of a bucket of datasets in one call of the fused
    triangular kernels, on a (T, B) grid.

    ``xb: (B, p, n)`` normalized rows, ``cb: (B, p, p)`` correlations, both
    float32 and contiguous, ``maskb: (B, p)`` bool live rows, ``n_valid``
    ``None`` or (B,) valid sample counts of zero-padded datasets. Returns
    (B, p) float32 scores (+inf on dead rows). Row i is bit-identical to
    ``fused_score_vector`` on dataset i: the thread layout is chosen from the
    per-dataset tile count, never from B or n."""
    _check(xb, cb, maskb, block, batched=True)
    if _fake.on_card(xb):
        _fake.note("fused_score_batch", flops(xb.shape[1], xb.shape[2], xb.shape[0]))
        return _buffers(xb, block)[1]
    if xb.device.type == "cpu":
        return fused_score_batch_ref(xb, cb, maskb, block=block, n_valid=n_valid)
    if xb.device.type != "cuda":
        raise ValueError(f"fused_score_batch runs on cuda or cpu, not {xb.device}")
    return launch_batch(xb, cb, maskb, _valid_counts(n_valid, xb.shape[0], xb.device),
                        block=block)


def tile_maps(nt: int) -> torch.Tensor:
    """(2, T) int32 row-block pairs (i, j), i <= j, of the sweep's grid, with
    T = nt (nt + 1) / 2, in row-major order: row block i's diagonal tile,
    then its tiles with j > i. Tile t writes row block i's partial scores to
    slot (i, j) and, off the diagonal, row block j's to slot (j, i)."""
    return torch.triu_indices(nt, nt, 0, dtype=torch.int32)


@functools.cache
def _device_tile_maps(nt: int, device):
    return tile_maps(nt).to(device)


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    fn = _build.load("fused_score").fused_score_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _buffers(xb, block: int):
    """The scratch (row entropies and per-tile partials) and the (B, p)
    scores a launch over the (B, p, n) bucket ``xb`` writes."""
    bsz, p, _ = xb.shape
    b = min(block, p)
    nt = -(-p // b)
    scratch = torch.empty(bsz * (p + nt * nt * b), dtype=torch.float32, device=xb.device)
    return scratch, torch.empty((bsz, p), dtype=torch.float32, device=xb.device)


def _launch(xb, cb, mb, nv, block: int):
    """The three CUDA kernels over a (B, p, n) bucket; returns (B, p) scores."""
    bsz, p, n = xb.shape
    b = min(block, p)
    nt = -(-p // b)
    lanes = _lanes(b, nt * (nt - 1) // 2)  # per-dataset tiles: independent of B
    ij = _device_tile_maps(nt, xb.device)
    scratch, out = _buffers(xb, block)
    rc = _entry()(
        xb.data_ptr(), cb.data_ptr(), mb.data_ptr(), None if nv is None else nv.data_ptr(),
        ij[0].data_ptr(), ij[1].data_ptr(), scratch.data_ptr(), out.data_ptr(),
        bsz, p, n, b, nt, lanes, _smem_bytes(b, lanes),
        torch.cuda.current_stream(xb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_score kernel launch failed with CUDA error {rc}")
    return out


def launch(xn, c, mask, nv=None, *, block: int = 8):
    """The kernels for one dataset, on checked inputs: ``nv`` (1,) int32 the
    valid count on the card, or ``None`` for all n samples."""
    global LAUNCHES
    out = _launch(xn[None], c[None], mask[None], nv, block)[0]
    with _count_mu:
        LAUNCHES += 1
    return out


def launch_batch(xb, cb, maskb, nv=None, *, block: int = 8):
    """The kernels for a bucket, on checked inputs: ``nv`` (B,) int32 valid
    counts on the card, or ``None`` for all n samples of every dataset."""
    global BATCH_LAUNCHES
    out = _launch(xb, cb, maskb, nv, block)
    with _count_mu:
        BATCH_LAUNCHES += 1
    return out


def math_probe(u):
    """The sweep's device functions on the card at float32 points ``u``
    (CUDA, contiguous): a (4, numel) tensor of exp(-2|u|), ``log1p_unit``
    of it, log cosh u and u exp(-u^2/2), to be measured against float64.
    Not a launch of the sweep: uncounted."""
    if u.device.type != "cuda" or u.dtype != torch.float32 or not u.is_contiguous():
        raise ValueError("math_probe takes a contiguous float32 CUDA tensor")
    from repro_torch.kernels import _build

    fn = _build.load("fused_score").fused_math_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((4, u.numel()), dtype=torch.float32, device=u.device)
    rc = fn(u.data_ptr(), out.data_ptr(), u.numel(),
            torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_math_probe launch failed with CUDA error {rc}")
    return out

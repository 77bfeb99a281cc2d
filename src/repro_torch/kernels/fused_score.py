"""Fused triangular score sweep: the CUDA kernel's wrappers and plain versions.

Replaces the TPU kernel ``_fused_tri_kernel`` of
``src/repro/kernels/fused_score.py`` through both of its entries:
``fused_score_vector`` (one dataset) and ``fused_score_batch`` (a bucket of
datasets on a (B, T) grid, one valid sample count per dataset). The
kernel, ``csrc/fused_score.cu``, visits every unordered off-diagonal pair of
row blocks once, streams the samples through shared memory, keeps the four
raw moment sums per row pair in registers, finalizes the entropies, the
antisymmetric stat and the messaging credits in the block, and writes
per-tile partial scores; a second kernel adds each row's partials in
ascending tile order (no atomics, so the f32 sum order is fixed).

Bound on the card: about three transcendentals (exp, log1p, exp) per
element of the (b, b, n) pair-sample cube per direction, so the sweep is
bound by the special-function units and the FP32 pipes, not by memory (it
reads each sample block a handful of times). The design keeps sample loads
in shared memory and the sums in registers, and widens the thread block when
the tile count is small so the late, small stages still fill the SMs.

The diagonal tiles and the row entropies stay torch ops
(``core.pairwise.fused_layout``), as the JAX wrapper leaves them to jnp.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core.covariance import _sample_count
from repro_torch.core.pairwise import fused_layout, fused_scores

#: Kernel launches since the last reset, one per call on the card:
#: ``LAUNCHES`` of ``fused_score_vector``, ``BATCH_LAUNCHES`` of
#: ``fused_score_batch``. Concurrent dispatcher threads count under a lock.
LAUNCHES = 0
BATCH_LAUNCHES = 0
_count_mu = threading.Lock()

_MAX_BLOCK = 32  # b * b pairs must fit one thread block
#: Samples per chunk staged in shared memory: 2 * 32 * 513 floats at the
#: largest block, well inside the card's 227 KiB per thread block.
BLOCK_N = 512
_FILL_THREADS = 132 * 2048  # resident threads of a full H100


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


def _valid_count(n_valid, n: int, device):
    """The finalize denominators on the card as float32 (one per dataset),
    or ``None`` when every sample is valid (the kernel divides by n)."""
    if n_valid is None:
        return None
    return _sample_count(n_valid, n).reshape(-1).to(device)


def _lanes(b: int, tiles: int) -> int:
    """Threads per row pair: 256-thread blocks, widened up to 1024 threads
    while the grid would leave the card's thread slots mostly empty."""
    npair = b * b
    lanes = max(1, 256 // npair, -(-2 * b // npair))
    while 2 * lanes * npair <= 1024 and tiles * lanes * npair < _FILL_THREADS:
        lanes *= 2
    return lanes


def fused_score_vector(xn, c, mask, *, block: int = 8, n_valid=None):
    """Messaging-folded score vector S via the fused triangular kernel.

    ``xn: (p, n)`` normalized rows, ``c: (p, p)`` correlations, both float32
    and contiguous, ``mask: (p,)`` bool live rows. Returns (p,) float32
    scores (+inf on dead rows). ``n_valid`` is the valid sample count of
    zero-padded data; it only changes the finalize denominator."""
    _check(xn, c, mask, block)
    if xn.device.type == "cpu":
        return fused_score_vector_ref(xn, c, mask, block=block, n_valid=n_valid)
    if xn.device.type != "cuda":
        raise ValueError(f"fused_score_vector runs on cuda or cpu, not {xn.device}")
    _, _, _, hxb, mb, s_diag = fused_layout(xn, c, mask, block, n_valid=n_valid)
    return launch(xn, c, hxb, mb, s_diag, _valid_count(n_valid, xn.shape[1], xn.device))


def fused_score_batch(xb, cb, maskb, *, block: int = 8, n_valid=None):
    """Score vectors of a bucket of datasets in one launch of the fused
    triangular kernel, on a (B, T) grid.

    ``xb: (B, p, n)`` normalized rows, ``cb: (B, p, p)`` correlations, both
    float32 and contiguous, ``maskb: (B, p)`` bool live rows, ``n_valid``
    ``None`` or (B,) valid sample counts of zero-padded datasets. Returns
    (B, p) float32 scores (+inf on dead rows). Row i is bit-identical to a
    one-dataset launch on dataset i's prologue inputs: the thread layout is
    chosen from the per-dataset tile count, never from B."""
    _check(xb, cb, maskb, block, batched=True)
    if xb.device.type == "cpu":
        return fused_score_batch_ref(xb, cb, maskb, block=block, n_valid=n_valid)
    if xb.device.type != "cuda":
        raise ValueError(f"fused_score_batch runs on cuda or cpu, not {xb.device}")
    _, _, _, hxb, mb, s_diag = fused_layout(xb, cb, maskb, block, n_valid=n_valid)
    return launch_batch(xb, cb, hxb, mb, s_diag,
                        _valid_count(n_valid, xb.shape[2], xb.device))


@functools.cache
def _tile_maps(nt: int, device):
    """(2, T) row-major (i < j) row-block pairs, made once per (nt, device)."""
    return torch.triu_indices(nt, nt, 1, device=device)


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    fn = _build.load("fused_score").fused_score_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xb, c, hxb, mb, s_diag, den):
    """Both CUDA kernels (tiles, then the ordered per-row reduce) over a
    (B, p, n) bucket; returns (B, p) scores."""
    bsz, p, n = xb.shape
    nt, b = mb.shape[-2:]
    tiles = nt * (nt - 1) // 2
    lanes = _lanes(b, tiles)  # per-dataset tiles: independent of B
    smem = 4 * max(2 * b * (BLOCK_N + 1), 4 * b * b * lanes + 2 * b * b)
    ij = _tile_maps(nt, xb.device)
    partial = torch.empty((bsz, tiles, 2, b), dtype=torch.float32, device=xb.device)
    out = torch.empty((bsz, p), dtype=torch.float32, device=xb.device)
    rc = _entry()(
        xb.data_ptr(), c.data_ptr(), hxb.data_ptr(), mb.data_ptr(),
        s_diag.data_ptr(), None if den is None else den.data_ptr(),
        ij[0].data_ptr(), ij[1].data_ptr(), partial.data_ptr(), out.data_ptr(),
        bsz, p, n, nt * b, b, nt, BLOCK_N, lanes, smem,
        torch.cuda.current_stream(xb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_score kernel launch failed with CUDA error {rc}")
    return out


def launch(xn, c, hxb, mb, s_diag, den=None):
    """The kernels for one dataset, on inputs the prologue has prepared:
    ``hxb``, ``mb``, ``s_diag`` (nt, b) from ``fused_layout`` and ``den``
    (1,) the valid count on the card, or ``None`` for all n samples."""
    global LAUNCHES
    out = _launch(xn[None], c, hxb, mb, s_diag, den)[0]
    with _count_mu:
        LAUNCHES += 1
    return out


def launch_batch(xb, cb, hxb, mb, s_diag, den=None):
    """The kernels for a bucket, on the batched prologue's inputs: ``hxb``,
    ``mb``, ``s_diag`` (B, nt, b) and ``den`` (B,) valid counts on the card,
    or ``None`` for all n samples of every dataset."""
    global BATCH_LAUNCHES
    out = _launch(xb, cb, hxb, mb, s_diag, den)
    with _count_mu:
        BATCH_LAUNCHES += 1
    return out

"""Square pairwise moments: the CUDA kernel's wrappers and plain versions.

Replaces the TPU kernel ``_pairwise_moments_kernel`` of
``src/repro/kernels/pairwise_score.py`` through its entry
``pairwise_moments``, for one dataset and, on a leading dataset axis, for a
bucket of datasets in one launch. The kernel, ``csrc/pairwise_moments.cu``,
emits the raw sums sum_k log cosh u_ij[k] and sum_k u_ij[k] exp(-u_ij[k]^2/2)
of every ordered pair, with u_ij = (x_i - c_ij x_j) / sqrt(max(1 - c_ij^2,
1e-12)): no 1/n and no entropy. :func:`pairwise_score` adds the torch
epilogue (``pairwise.finalize_moments``).

Optional live-row masks and valid sample counts restrict the work to what a
score needs: the sums of a pair with a dead row are exactly 0 (a select),
and the sums run over the first ``n_valid`` samples only, so a zero-padded
buffer with ``n_valid`` gives the bits of the unpadded one. The kernel
skips tiles with no live pair and stops each dataset at its valid count.

Bound on the card: the FP32 pipe, at the math of one direction of the fused
sweep per (ordered pair, sample); it reads each sample once per 8-row tile
and keeps a thread's 2 x 2 pairs' sums in registers (see the source).

The diagonal of the sums is noise: c_ii ~ 1 drives 1 / sqrt(max(1 - c^2,
1e-12)) up to 1e6, so the (i, i) residual is rounding error amplified, and
any two implementations disagree there. It never reaches a score
(``pair_stat_matrix`` is exactly 0 on the diagonal and ``scores_from_stats``
masks it), so comparisons hold the live off-diagonal entries only.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise; on a fake CUDA tensor (the dry run's) they
allocate what the launch writes and note its ``flops``
(``kernels/_fake.py``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.covariance import VAR_EPS, _sample_count, per_dataset
from repro_torch.core.entropy import log_cosh, u_exp_moment
from repro_torch.core.pairwise import finalize_moments
from repro_torch.kernels import _fake
from repro_torch.kernels.fused_score import FP32_PER_PAIR_SAMPLE, _valid_counts

#: Kernel launches since the last reset, one per call on the card:
#: ``LAUNCHES`` of ``pairwise_moments``, ``BATCH_LAUNCHES`` of
#: ``pairwise_moments_batch``. Concurrent dispatcher threads count under a lock.
LAUNCHES = 0
BATCH_LAUNCHES = 0
_count_mu = threading.Lock()

#: Output tile of one thread block (rows of xi x rows of xj), as on the TPU.
BLOCK_I = BLOCK_J = 8
#: A thread's pairs: a MICRO x MICRO micro-tile; 16 micro-tiles per tile.
MICRO = 2
MICRO_TILES = (BLOCK_I // MICRO) * (BLOCK_J // MICRO)
#: Samples per summation chunk; the plain version pads n to a multiple of
#: it, as the TPU kernel does.
BLOCK_N = 512


def flops(pi: int, pj: int, n: int, batch: int = 1) -> float:
    """The FP32 operations of one launch over ``batch`` datasets of (pi, pj)
    ordered pairs and n samples, every pair and sample live: one direction
    of the fused sweep's math per (ordered pair, sample), half its FP32
    instructions (``fused_score.FP32_PER_PAIR_SAMPLE``), as the bound
    counts them."""
    return float(batch * pi * pj * n * FP32_PER_PAIR_SAMPLE // 2)
#: Element budget of one chunk of the plain version's (pi, cols, n) residuals.
CHUNK_ELEMS = 1 << 24
_FILL_THREADS = 132 * 2048  # resident threads of a full H100

#: Tolerance of a kernel sum against its plain version, per unit of
#: A_ij = sum_k (|u_ij[k]| + 1): both integrands are at most |u| + log 2 in
#: size and log cosh cancels against log 2 near 0, so every term carries an
#: absolute error of a few ulps of (|u| + 1) and every partial sum is at most
#: A. The two sides round each term alike (same f32 residual, the kernel's
#: polynomial log1p against torch's) and sum in different orders (per-thread
#: chunks of 512 / lanes terms, ~n / 512 chunks and the lanes, against
#: torch's tree sum): a few hundred roundings of partial sums, the largest of
#: which are near A, whose errors mostly cancel. 64 ulps of A leaves room for
#: that and still refuses a wrong pair, sample or chunk, which moves a sum by
#: O(sqrt n) or more.
SUM_TOL = 64 * torch.finfo(torch.float32).eps


def _valid_samples(x, n_valid):
    """``x: (..., p, n)`` with the samples at or past each dataset's valid
    count set to 0 (a select: they may hold anything); ``n_valid`` None, one
    count, or one per dataset of the leading axes."""
    if n_valid is None:
        return x
    lead = x.shape[:-2]
    nv = torch.as_tensor(n_valid, device=x.device).reshape(-1).expand(lead.numel())
    keep = torch.arange(x.shape[-1], device=x.device) < nv.reshape(*lead, 1, 1)
    return torch.where(keep, x, 0.0)


def _residual_chunks(xi, xj, c):
    """Yield the (..., pi, cols, n_pad) residuals of each column chunk of xj,
    n zero-padded to a multiple of ``BLOCK_N``."""
    n = xi.shape[-1]
    pad = (-n) % BLOCK_N
    xi, xj = F.pad(xi, (0, pad)), F.pad(xj, (0, pad))
    inv = 1.0 / torch.sqrt(torch.clamp(1.0 - torch.square(c), min=VAR_EPS))  # as the kernel
    lead = xi.shape[:-2].numel()
    step = max(1, CHUNK_ELEMS // max(lead * xi.shape[-2] * xi.shape[-1], 1))
    for j0 in range(0, xj.shape[-2], step):
        sl = slice(j0, j0 + step)
        u = (xi[..., :, None, :] - c[..., :, sl, None] * xj[..., None, sl, :]) \
            * inv[..., :, sl, None]
        yield u


def _chunked_sum(t):
    """Sum over the last axis as the kernel sums: per ``BLOCK_N`` chunk, then
    the chunk sums one after another from sample 0, so trailing zero chunks
    change nothing."""
    parts = torch.sum(t.reshape(*t.shape[:-1], -1, BLOCK_N), dim=-1)
    out = parts[..., 0]
    for k in range(1, parts.shape[-1]):
        out = out + parts[..., k]
    return out


def pairwise_moments_ref(xi, xj, c, *, live_i=None, live_j=None, n_valid=None):
    """Plain version: the raw sums as torch ops, n zero-padded to a multiple
    of ``BLOCK_N`` and summed chunk by chunk (so zero-padding n leaves them
    bit for bit as they were). Takes any leading dataset axes: ``xi: (...,
    pi, n)``, ``xj: (..., pj, n)``, ``c: (..., pi, pj)``; ``live_i: (...,
    pi)`` and ``live_j: (..., pj)`` bool live rows (None: all live), whose
    dead pairs get exactly 0 by select; ``n_valid`` None, one count, or one
    per dataset: samples from there on count as 0. Returns ``(m1_sum,
    m2_sum)``, each (..., pi, pj)."""
    xi, xj = _valid_samples(xi, n_valid), _valid_samples(xj, n_valid)
    m1, m2 = [], []
    for u in _residual_chunks(xi, xj, c):
        m1.append(_chunked_sum(log_cosh(u)))
        m2.append(_chunked_sum(u_exp_moment(u)))
    m1, m2 = torch.cat(m1, dim=-1), torch.cat(m2, dim=-1)
    if live_i is None and live_j is None:
        return m1, m2
    live = torch.ones(m1.shape, dtype=torch.bool, device=m1.device)
    if live_i is not None:
        live = live & live_i[..., :, None]
    if live_j is not None:
        live = live & live_j[..., None, :]
    return torch.where(live, m1, 0.0), torch.where(live, m2, 0.0)


def pairwise_moments_batch_ref(xb, cb, *, mask=None, n_valid=None):
    """Plain version of the batched entry: the square sums of each dataset of
    ``xb: (B, m, n)`` against itself, ``cb: (B, m, m)``, ``mask: (B, m)``
    live rows or None, ``n_valid`` None or (B,)."""
    return pairwise_moments_ref(xb, xb, cb, live_i=mask, live_j=mask, n_valid=n_valid)


def sum_tolerance(xi, xj, c, n_valid=None):
    """Per-entry tolerance ``SUM_TOL * sum_k (|u_ij[k]| + 1)`` of a kernel sum
    against its plain version, over the valid samples (see ``SUM_TOL``)."""
    count = per_dataset(_sample_count(n_valid, xi.shape[-1]), xi.ndim)
    if isinstance(count, torch.Tensor):
        count = count.to(xi.device)
    xi, xj = _valid_samples(xi, n_valid), _valid_samples(xj, n_valid)
    return SUM_TOL * (torch.cat(
        [torch.sum(torch.abs(u), dim=-1) for u in _residual_chunks(xi, xj, c)],
        dim=-1) + count)


def _check(xi, xj, c, batched: bool):
    lead = 1 if batched else 0
    want = "(B, p, n)" if batched else "(p, n)"
    if xi.ndim != 2 + lead or xj.ndim != 2 + lead or min(xi.shape) < 1 or min(xj.shape) < 1:
        raise ValueError(f"xi and xj must be {want} with p, n >= 1, got "
                         f"{tuple(xi.shape)} and {tuple(xj.shape)}")
    if xi.shape[:lead] != xj.shape[:lead] or xi.shape[-1] != xj.shape[-1]:
        raise ValueError(f"xi {tuple(xi.shape)} and xj {tuple(xj.shape)} differ in "
                         "their dataset or sample axes")
    want_c = (*xi.shape[:lead], xi.shape[-2], xj.shape[-2])
    if tuple(c.shape) != want_c:
        raise ValueError(f"want c {want_c}, got {tuple(c.shape)}")
    if not (xi.dtype == xj.dtype == c.dtype == torch.float32):
        raise TypeError(f"xi, xj and c must be float32, got {xi.dtype}, {xj.dtype}, {c.dtype}")
    if not (xi.device == xj.device == c.device):
        raise ValueError("xi, xj and c must be on one device")
    if not (xi.is_contiguous() and xj.is_contiguous() and c.is_contiguous()):
        raise ValueError("xi, xj and c must be contiguous")
    if xi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pairwise_moments runs on cuda or cpu, not {xi.device}")


def _check_live(live, x, name: str):
    if live is None:
        return
    if tuple(live.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"want {name} {tuple(x.shape[:-1])}, got {tuple(live.shape)}")
    if live.dtype != torch.bool:
        raise TypeError(f"{name} must be bool, got {live.dtype}")
    if live.device != x.device or not live.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on {x.device}")


def _lanes(tiles: int) -> int:
    """Threads per micro-tile: 32 (512-thread blocks), or 64 (1024 threads)
    while the grid would leave the card's thread slots mostly empty. A
    function of the per-dataset tile count only, so a dataset's sums never
    depend on the batch it was launched in."""
    return 64 if tiles * MICRO_TILES * 32 < _FILL_THREADS else 32


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    fn = _build.load("pairwise_moments").pairwise_moments_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sums(xi, xj):
    """The two (B, pi, pj) float32 sums a launch over (B, pi, n) x (B, pj,
    n) writes."""
    m1 = torch.empty((xi.shape[0], xi.shape[1], xj.shape[1]), dtype=torch.float32,
                     device=xi.device)
    return m1, torch.empty_like(m1)


def _launch(xi, xj, c, live_i=None, live_j=None, nv=None):
    """The CUDA kernel over (B, pi, n) x (B, pj, n), on checked inputs:
    ``live_i``/``live_j`` (B, pi)/(B, pj) bool or None, ``nv`` (B,) int32 on
    the card or None. Returns the two (B, pi, pj) raw sums."""
    bsz, pi, n = xi.shape
    pj = xj.shape[1]
    tiles = -(-pi // BLOCK_I) * -(-pj // BLOCK_J)
    m1, m2 = _sums(xi, xj)
    rc = _entry()(xi.data_ptr(), xj.data_ptr(), c.data_ptr(),
                  None if live_i is None else live_i.data_ptr(),
                  None if live_j is None else live_j.data_ptr(),
                  None if nv is None else nv.data_ptr(), m1.data_ptr(), m2.data_ptr(),
                  bsz, pi, pj, n, _lanes(tiles),
                  torch.cuda.current_stream(xi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_moments kernel launch failed with CUDA error {rc}")
    return m1, m2


def occupancy(lanes: int) -> int:
    """Resident blocks per SM of the tile kernel at ``lanes`` threads per
    micro-tile, as the built kernel's registers and shared memory allow."""
    from repro_torch.kernels import _build

    fn = _build.load("pairwise_moments").pairwise_moments_occupancy
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    blocks = ctypes.c_int(0)
    rc = fn(lanes, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"pairwise_moments occupancy query failed with CUDA error {rc}")
    return blocks.value


def pairwise_moments(xi, xj, c, *, live_i=None, live_j=None, n_valid=None):
    """Raw moment sums of every (i, j) residual stream of one dataset.

    ``xi: (pi, n)`` and ``xj: (pj, n)`` normalized rows (``xi is xj`` for
    the square), ``c: (pi, pj)`` their correlations, all float32 and
    contiguous; ``live_i: (pi,)``, ``live_j: (pj,)`` bool live rows or None
    (all live); ``n_valid`` the valid sample count of zero-padded rows, or
    None. Returns ``(m1_sum, m2_sum)``, each (pi, pj) float32, exactly 0 on
    pairs with a dead row; finish them with ``pairwise.finalize_moments``."""
    global LAUNCHES
    _check(xi, xj, c, batched=False)
    _check_live(live_i, xi, "live_i")
    _check_live(live_j, xj, "live_j")
    if _fake.on_card(xi):
        _fake.note("pairwise_moments", flops(xi.shape[0], xj.shape[0], xi.shape[1]))
        m1, m2 = _sums(xi[None], xj[None])
        return m1[0], m2[0]
    if xi.device.type == "cpu":
        return pairwise_moments_ref(xi, xj, c, live_i=live_i, live_j=live_j, n_valid=n_valid)
    m1, m2 = _launch(xi[None], xj[None], c[None],
                     None if live_i is None else live_i[None],
                     None if live_j is None else live_j[None],
                     _valid_counts(n_valid, 1, xi.device))
    with _count_mu:
        LAUNCHES += 1
    return m1[0], m2[0]


def pairwise_moments_batch(xb, cb, *, mask=None, n_valid=None):
    """The square raw sums of a bucket of datasets in one launch, on a
    (tiles_i, tiles_j, B) grid: ``xb: (B, m, n)`` normalized rows, ``cb:
    (B, m, m)`` correlations, ``mask: (B, m)`` bool live rows or None,
    ``n_valid`` None or (B,) valid sample counts. Returns two (B, m, m)
    float32 tensors. Row b is bit-identical to a one-dataset launch on
    dataset b."""
    global BATCH_LAUNCHES
    _check(xb, xb, cb, batched=True)
    _check_live(mask, xb, "mask")
    if _fake.on_card(xb):
        _fake.note("pairwise_moments_batch", flops(xb.shape[1], xb.shape[1], xb.shape[2],
                                                   xb.shape[0]))
        return _sums(xb, xb)
    if xb.device.type == "cpu":
        return pairwise_moments_batch_ref(xb, cb, mask=mask, n_valid=n_valid)
    out = _launch(xb, xb, cb, mask, mask, _valid_counts(n_valid, xb.shape[0], xb.device))
    with _count_mu:
        BATCH_LAUNCHES += 1
    return out


def finalize(m1_sum, m2_sum, n: int, n_valid=None):
    """Entropies of raw sums over ``n`` sample columns, ``n_valid`` None, one
    count, or one per dataset of a leading axis."""
    den = per_dataset(_sample_count(n_valid, n), m1_sum.ndim)
    if isinstance(den, torch.Tensor):
        den = den.to(m1_sum.device)
    return finalize_moments(m1_sum, m2_sum, den)


def pairwise_score(xn, c, *, mask=None, n_valid=None):
    """HR matrix of one dataset: the kernel's raw sums plus the torch entropy
    epilogue. ``xn: (p, n)`` normalized rows, ``c: (p, p)``, ``mask: (p,)``
    live rows or None. Returns (p, p); entries of dead pairs are the entropy
    of zero sums, for ``scores_from_stats``' select to drop."""
    return finalize(*pairwise_moments(xn, xn, c, live_i=mask, live_j=mask, n_valid=n_valid),
                    xn.shape[-1], n_valid)


def pairwise_score_batch(xb, cb, *, mask=None, n_valid=None):
    """HR matrices of a bucket in one launch: ``xb: (B, m, n)``, ``cb:
    (B, m, m)``, ``mask: (B, m)`` or None, ``n_valid`` None or (B,).
    Returns (B, m, m)."""
    return finalize(*pairwise_moments_batch(xb, cb, mask=mask, n_valid=n_valid),
                    xb.shape[-1], n_valid)

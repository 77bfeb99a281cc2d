"""Square pairwise moments: the CUDA kernel's wrappers and plain versions.

Replaces the TPU kernel ``_pairwise_moments_kernel`` of
``src/repro/kernels/pairwise_score.py`` through its entry
``pairwise_moments``, for one dataset and, on a leading dataset axis, for a
bucket of datasets in one launch. The kernel, ``csrc/pairwise_moments.cu``,
emits the raw sums sum_k log cosh u_ij[k] and sum_k u_ij[k] exp(-u_ij[k]^2/2)
of every ordered pair, with u_ij = (x_i - c_ij x_j) / sqrt(max(1 - c_ij^2,
1e-12)): no 1/n and no entropy. :func:`pairwise_score` adds the torch
epilogue (``pairwise.finalize_moments``), which owns the ``n_valid``
denominator.

Bound on the card: three transcendentals per (ordered pair, sample), so the
kernel is bound by the special-function units; it reads each sample once per
8-row tile and keeps both sums of a pair in registers (see the source).

The diagonal of the sums is noise: c_ii ~ 1 drives 1 / sqrt(max(1 - c^2,
1e-12)) up to 1e6, so the (i, i) residual is rounding error amplified, and
any two implementations disagree there. It never reaches a score
(``pair_stat_matrix`` is exactly 0 on the diagonal and ``scores_from_stats``
masks it), so comparisons hold the off-diagonal entries only.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.
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

#: Kernel launches since the last reset, one per call on the card:
#: ``LAUNCHES`` of ``pairwise_moments``, ``BATCH_LAUNCHES`` of
#: ``pairwise_moments_batch``. Concurrent dispatcher threads count under a lock.
LAUNCHES = 0
BATCH_LAUNCHES = 0
_count_mu = threading.Lock()

#: Output tile of one thread block (rows of xi x rows of xj), as on the TPU.
BLOCK_I = BLOCK_J = 8
#: Samples per chunk staged in shared memory (2 * 8 * 513 floats); the plain
#: version pads n to a multiple of it, as the TPU kernel does.
BLOCK_N = 512
#: Element budget of one chunk of the plain version's (pi, cols, n) residuals.
CHUNK_ELEMS = 1 << 24
_FILL_THREADS = 132 * 2048  # resident threads of a full H100

#: Tolerance of a kernel sum against its plain version, per unit of
#: A_ij = sum_k (|u_ij[k]| + 1): both integrands are at most |u| + log 2 in
#: size and log cosh cancels against log 2 near 0, so every term carries an
#: absolute error of a few ulps of (|u| + 1) and every partial sum is at most
#: A. The two sides round each term alike (same f32 residual, libdevice vs
#: torch transcendentals) and sum in different orders (per-thread chunks of
#: 512 / lanes terms, ~n / 512 chunks and the lanes, against torch's tree
#: sum): a few hundred roundings of partial sums, the largest of which are
#: near A, whose errors mostly cancel. 64 ulps of A leaves room for that and
#: still refuses a wrong pair, sample or chunk, which moves a sum by O(sqrt n)
#: or more.
SUM_TOL = 64 * torch.finfo(torch.float32).eps


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


def pairwise_moments_ref(xi, xj, c):
    """Plain version: the raw sums as torch ops, n zero-padded to a multiple
    of ``BLOCK_N`` and summed chunk by chunk (so zero-padding n leaves them
    bit for bit as they were). Takes any leading dataset axes: ``xi: (...,
    pi, n)``, ``xj: (..., pj, n)``, ``c: (..., pi, pj)``. Returns
    ``(m1_sum, m2_sum)``, each (..., pi, pj)."""
    m1, m2 = [], []
    for u in _residual_chunks(xi, xj, c):
        m1.append(_chunked_sum(log_cosh(u)))
        m2.append(_chunked_sum(u_exp_moment(u)))
    return torch.cat(m1, dim=-1), torch.cat(m2, dim=-1)


def pairwise_moments_batch_ref(xb, cb):
    """Plain version of the batched entry: the square sums of each dataset of
    ``xb: (B, m, n)`` against itself, ``cb: (B, m, m)``."""
    return pairwise_moments_ref(xb, xb, cb)


def sum_tolerance(xi, xj, c):
    """Per-entry tolerance ``SUM_TOL * sum_k (|u_ij[k]| + 1)`` of a kernel sum
    against its plain version (see ``SUM_TOL``)."""
    n = xi.shape[-1]
    return SUM_TOL * torch.cat(
        [torch.sum(torch.abs(u), dim=-1) + n for u in _residual_chunks(xi, xj, c)],
        dim=-1)


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


def _lanes(tiles: int) -> int:
    """Threads per pair: 256-thread blocks, widened up to 1024 threads while
    the grid would leave the card's thread slots mostly empty. A function of
    the per-dataset tile count only, so a dataset's sums never depend on the
    batch it was launched in."""
    lanes = 4
    while 2 * lanes * BLOCK_I * BLOCK_J <= 1024 and tiles * lanes * BLOCK_I * BLOCK_J < _FILL_THREADS:
        lanes *= 2
    return lanes


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    fn = _build.load("pairwise_moments").pairwise_moments_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xi, xj, c):
    """The CUDA kernel over (B, pi, n) x (B, pj, n); returns the two
    (B, pi, pj) raw sums."""
    bsz, pi, n = xi.shape
    pj = xj.shape[1]
    tiles = -(-pi // BLOCK_I) * -(-pj // BLOCK_J)
    m1 = torch.empty((bsz, pi, pj), dtype=torch.float32, device=xi.device)
    m2 = torch.empty_like(m1)
    rc = _entry()(xi.data_ptr(), xj.data_ptr(), c.data_ptr(), m1.data_ptr(),
                  m2.data_ptr(), bsz, pi, pj, n, _lanes(tiles),
                  torch.cuda.current_stream(xi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_moments kernel launch failed with CUDA error {rc}")
    return m1, m2


def pairwise_moments(xi, xj, c):
    """Raw moment sums of every (i, j) residual stream of one dataset.

    ``xi: (pi, n)`` and ``xj: (pj, n)`` normalized rows (``xi is xj`` for
    the square), ``c: (pi, pj)`` their correlations, all float32 and
    contiguous. Returns ``(m1_sum, m2_sum)``, each (pi, pj) float32; finish
    them with ``pairwise.finalize_moments``."""
    global LAUNCHES
    _check(xi, xj, c, batched=False)
    if xi.device.type == "cpu":
        return pairwise_moments_ref(xi, xj, c)
    m1, m2 = _launch(xi[None], xj[None], c[None])
    with _count_mu:
        LAUNCHES += 1
    return m1[0], m2[0]


def pairwise_moments_batch(xb, cb):
    """The square raw sums of a bucket of datasets in one launch, on a
    (tiles_i, tiles_j, B) grid: ``xb: (B, m, n)`` normalized rows, ``cb:
    (B, m, m)`` correlations. Returns two (B, m, m) float32 tensors. Row b is
    bit-identical to a one-dataset launch on dataset b."""
    global BATCH_LAUNCHES
    _check(xb, xb, cb, batched=True)
    if xb.device.type == "cpu":
        return pairwise_moments_batch_ref(xb, cb)
    out = _launch(xb, xb, cb)
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


def pairwise_score(xn, c, *, n_valid=None):
    """HR matrix of one dataset: the kernel's raw sums plus the torch entropy
    epilogue. ``xn: (p, n)`` normalized rows, ``c: (p, p)``. Returns (p, p)."""
    return finalize(*pairwise_moments(xn, xn, c), xn.shape[-1], n_valid)


def pairwise_score_batch(xb, cb, *, n_valid=None):
    """HR matrices of a bucket in one launch: ``xb: (B, m, n)``, ``cb:
    (B, m, m)``, ``n_valid`` None or (B,). Returns (B, m, m)."""
    return finalize(*pairwise_moments_batch(xb, cb), xb.shape[-1], n_valid)

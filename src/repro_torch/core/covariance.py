"""Normalization, covariance, and the paper's Eq. (10)/(11) rank-1 updates.

Math simplification (paper Section 3.4): with normalized rows,

  Eq. (10):  var(r_i^(j))            = 1 - cov(x_i, x_j)^2
  Eq. (11):  cov(r_i^root, r_j^root) = cov(x_i, x_j) - b_i * b_j
             with b_k = cov(x_k, x_root);
             renormalized:  C'[i,j] = (C[i,j] - b_i b_j) / (s_i s_j),
             s_k = sqrt(1 - b_k^2).

These let every iteration after the first run off the covariance matrix alone
(UpdateCovMat, Algorithm 8) plus a rank-1 data refresh (UpdateData,
Algorithm 7) — no per-pair sample regressions.

Every function also takes a leading dataset axis: ``x: (B, p, n)``,
``cov: (B, p, p)``, ``mask: (B, p)``, ``root: (B,)`` and ``n_valid: (B,)``,
which is how the batched estimator runs a bucket of datasets at once. The
root is a Python int, a 0-dim or a (B,) device tensor and is gathered with
``take_along_dim``, so the causal-order driver never syncs it to the host.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# Guard for 1 - cov^2 when |cov| -> 1 (numerically collinear variables).
VAR_EPS = 1e-12
# Floor used by the *iteration updates*: caps the per-iteration amplification
# of numerically collinear residuals at 1/sqrt(COLLINEAR_FLOOR) = 100x and is
# followed by an explicit renormalization (update_data), so drift cannot
# compound into overflow across the p iterations.
COLLINEAR_FLOOR = 1e-4


def _sample_count(n_valid, n: int, ddof: int = 0):
    """Effective sample count minus ``ddof`` (>= 1).

    ``n_valid`` is the padding seam: the count of valid samples when the
    trailing sample axis is zero-padded up to a shape bucket. ``None`` gives
    a Python int (the static axis length); otherwise a float32 tensor. Every
    function below that divides by a function of n routes the denominator
    through here so padded and unpadded datasets produce identical
    statistics."""
    if n_valid is None:
        return max(n - ddof, 1)
    return torch.clamp(torch.as_tensor(n_valid) - ddof, min=1).to(torch.float32)


def per_dataset(v, ndim: int):
    """A per-dataset value of shape (B,) reshaped to (B, 1, ..., 1), so that it
    broadcasts against an ``ndim``-dim tensor whose leading axis is the
    dataset axis. Python numbers and 0-dim tensors pass through unchanged."""
    if isinstance(v, torch.Tensor) and v.ndim:
        return v.reshape(v.shape + (1,) * (ndim - v.ndim))
    return v


def sample_mask(n: int, n_valid, device=None):
    """Bool mask of valid sample columns that broadcasts against (p, n) or,
    for a (B,) ``n_valid``, against (B, p, n) (``None`` -> all valid)."""
    if n_valid is None:
        return None
    nv = torch.as_tensor(n_valid, device=device)
    return torch.arange(n, device=device) < nv[..., None, None]


def _row(t, root):
    """``t[..., root, :]`` as a (..., 1, n) slice, one root per dataset,
    without a host sync on ``root``."""
    root = torch.as_tensor(root, device=t.device)
    return torch.take_along_dim(t, root[..., None, None], dim=-2)


def _col(t, root):
    """``t[..., :, root]`` as a (..., p) vector, one root per dataset."""
    root = torch.as_tensor(root, device=t.device)
    return torch.take_along_dim(t, root[..., None, None], dim=-1)[..., 0]


def normalize(x, axis: int = -1, ddof: int = 1, n_valid=None):
    """Standardize samples along ``axis`` (zero mean, unit adjusted variance).

    With ``n_valid`` set (requires ``axis=-1``), sample columns at index >=
    n_valid are treated as padding: means/variances divide by ``n_valid`` and
    the padded columns come back *exactly zero*, which makes the padding
    invisible to every downstream moment sum."""
    smask = sample_mask(x.shape[-1], n_valid, x.device)
    if smask is None:
        mean = torch.mean(x, dim=axis, keepdim=True)
        centered = x - mean
    else:
        if axis not in (-1, x.ndim - 1):
            raise ValueError("n_valid requires the sample axis last")
        xz = torch.where(smask, x, 0.0)
        mean_den = per_dataset(_sample_count(n_valid, x.shape[axis]), x.ndim)
        mean = torch.sum(xz, dim=axis, keepdim=True) / mean_den
        centered = torch.where(smask, x - mean, 0.0)
    var_den = per_dataset(_sample_count(n_valid, x.shape[axis], ddof), x.ndim)
    var = torch.sum(torch.square(centered), dim=axis, keepdim=True) / var_den
    return centered / torch.sqrt(torch.clamp(var, min=VAR_EPS))


class _PrecisionScope:
    """The process-wide float32 matmul precision, held at "highest" while any
    thread is inside :func:`full_precision_matmul`. The setting is global,
    so concurrent fits (a replicated serving engine) share one counted
    scope: the first thread in saves the caller's setting, the last one out
    restores it, and no thread's product runs at the caller's lower
    precision while another thread is still inside."""

    def __init__(self):
        self._mu = threading.Lock()
        self._inside = 0
        self._saved = None

    def enter(self):
        with self._mu:
            if self._inside == 0:
                self._saved = torch.get_float32_matmul_precision()
                torch.set_float32_matmul_precision("highest")
            self._inside += 1

    def leave(self):
        with self._mu:
            self._inside -= 1
            if self._inside == 0:
                torch.set_float32_matmul_precision(self._saved)


_PRECISION = _PrecisionScope()


@contextlib.contextmanager
def full_precision_matmul():
    """Run float32 matmuls at full precision inside the block and restore
    the caller's setting after the last thread inside leaves it: the causal
    order depends on the correlations these products give. Precision
    "highest" also turns off cuBLAS's TF32
    (``torch.backends.cuda.matmul.allow_tf32`` reads False)."""
    _PRECISION.enter()
    try:
        yield
    finally:
        _PRECISION.leave()


def cov_matrix(xn, ddof: int = 1, n_valid=None):
    """Covariance matrix of row-variables ``xn: (..., p, n)`` (normalized
    rows -> correlation matrix with unit diagonal), at full float32
    precision. Zero-padded sample columns contribute nothing to the dot
    products, so only the denominator needs the true count.

    The Gram matrix is one GEMM per dataset, never a batched one: cuBLAS
    picks its algorithm, and so the order of each n-term dot product, from
    the batch count (measured on an H100: a batch of 8 and a batch of 1
    round differently). Per-dataset products keep a dataset's correlations,
    and with them its causal order, independent of the batch it rides in."""
    flat = xn.reshape(-1, *xn.shape[-2:])
    with full_precision_matmul():
        gram = torch.stack([m @ m.mT for m in flat])
    gram = gram.reshape(*xn.shape[:-1], xn.shape[-2])
    return gram / per_dataset(_sample_count(n_valid, xn.shape[-1], ddof), xn.ndim)


def residual_std(cov_ij):
    """sqrt(var(r_i^(j))) = sqrt(1 - cov^2) per paper Eq. (10)."""
    return torch.sqrt(torch.clamp(1.0 - torch.square(cov_ij), min=VAR_EPS))


def rank1_gates(b_raw, live):
    """The gated (b, s) pair both Eq. (10)/(11) rank-1 updates are built on:
    clipped regression coefficient and floored residual scale, with dead
    entries passing through unchanged (b = 0, s = 1)."""
    b = torch.where(live, torch.clamp(b_raw, -1.0, 1.0), 0.0)
    s = torch.sqrt(torch.clamp(1.0 - torch.square(b), min=COLLINEAR_FLOOR))
    return b, s


def update_data(x, cov, root, mask, n_valid=None):
    """UpdateData (Algorithm 7): regress the root out of every remaining row
    and renormalize via Eq. (10). Fully vectorized rank-1 update.

    ``x: (..., p, n)`` normalized rows, ``cov: (..., p, p)``, ``root`` one
    index per dataset, ``mask: (..., p) bool`` rows still in U (including
    the root before removal). Rows not in U (and the root row itself) are
    left untouched.

    Eq. (10) renormalization is exact in infinite precision; in f32 the
    residual variance drifts from 1 over many iterations, so the Eq. (10)
    scale is floored and followed by an explicit sample renormalization — a
    mathematical no-op that keeps the invariant var(row) = 1."""
    p, n = x.shape[-2:]
    root = torch.as_tensor(root, device=x.device)
    live = mask & (torch.arange(p, device=x.device) != root[..., None])
    b, s = rank1_gates(_col(cov, root), live)
    out = (x - b[..., :, None] * _row(x, root)) / s[..., :, None]
    # drift correction (exact renormalization of live rows)
    var_den = per_dataset(_sample_count(n_valid, n, 1), x.ndim)
    var = torch.sum(torch.square(out), dim=-1, keepdim=True) / var_den
    scale = torch.where(live[..., None], torch.rsqrt(torch.clamp(var, min=VAR_EPS)), 1.0)
    return out * scale


def update_cov(cov, root, mask):
    """UpdateCovMat (Algorithm 8): Eq. (11) rank-1 covariance update with
    Eq. (10) renormalization. Entries involving removed rows are garbage by
    contract and masked by callers."""
    p = cov.shape[-1]
    root = torch.as_tensor(root, device=cov.device)
    live = mask & (torch.arange(p, device=cov.device) != root[..., None])
    b, s = rank1_gates(_col(cov, root), live)
    new = (cov - b[..., :, None] * b[..., None, :]) / (s[..., :, None] * s[..., None, :])
    # Correlations cannot exceed 1; clipping prevents drift compounding.
    new = torch.clamp(new, -1.0, 1.0)
    # Keep the diagonal exactly 1 (it is mathematically 1).
    eye = torch.eye(p, dtype=torch.bool, device=cov.device)
    return torch.where(eye, 1.0, new)

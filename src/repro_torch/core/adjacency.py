"""DirectLiNGAM step 2 on the device: causal strengths B + noise variances
from a causal order.

Same closed form as the numpy oracle (``repro_torch.core.pruning``): with
the rows in causal order, Sigma = A Omega A^T for the unit-lower-triangular
A = (I - B)^{-1}, so one jittered Cholesky + one unit-lower triangular solve
give B = I - A^{-1} and Omega = diag(L)^2. Running it as torch ops keeps
phase 2 on the device right behind the causal-order scan, with no host
round-trip between the phases.

Two numerical deviations from the oracle, both deliberate:

  * **correlation scaling** — the Cholesky runs on the correlation matrix R
    (rows pre-scaled by their sample std) rather than the raw covariance
    Sigma. Since Sigma = D R D for diagonal D, chol(Sigma) = D chol(R); B and
    Omega are recovered by undoing the scaling. In f32 this is better
    conditioned than factoring Sigma directly.
  * **jitter placement** — the oracle adds ``JITTER_SCALE * mean(var)`` to
    Sigma's diagonal; here ``JITTER_SCALE * mean(diag R)`` is added to R,
    the same relative ridge applied per-variable instead of uniformly.

Padding contracts (the batched seam, shared with the scan driver):

  * ``mask`` marks live variable rows; padded (dead) rows must be zero in
    ``x`` and sit *after* all live entries in ``order`` (use
    :func:`complete_order` to sanitize a scan-driver order). Dead rows come
    back with zero B rows/columns and zero noise variance.
  * ``n_valid`` counts valid sample columns (``covariance.normalize``
    contract: padded columns zero).

Both functions take a leading dataset axis as well (``x: (B, p, n)``,
``order``/``mask: (B, p)``, ``n_valid: (B,)``); every reduction and every
escalation of the jitter ladder is per dataset. The Gram product and the
Cholesky factorizations run one dataset at a time (:func:`_each`): on an
H100 cuBLAS and cuSOLVER round a batch of 8 otherwise than a batch of 1, so
a batched call would make a dataset's B and noise variances depend on the
bucket it rides in (measured; the triangular solve was batch-invariant and
stays batched).
"""

from __future__ import annotations

import torch

from repro_torch.core.covariance import (
    VAR_EPS,
    _sample_count,
    full_precision_matmul,
    per_dataset,
    sample_mask,
)
from repro_torch.core.pruning import JITTER_SCALE


def complete_order(order, mask):
    """Extend a scan-driver causal order over a padded buffer into a full
    permutation of ``0..p-1``: the first ``sum(mask)`` entries are the live
    variables, the garbage entries past them are replaced by the dead
    variable ids in ascending order."""
    p = order.shape[-1]
    p_live = torch.sum(mask, dim=-1, keepdim=True)
    valid_pos = torch.arange(p, device=order.device) < p_live
    seen = torch.zeros(order.shape, dtype=torch.int32, device=order.device)
    seen = seen.scatter_add(-1, order.long(), valid_pos.to(torch.int32)) > 0
    # unseen ids first, ascending (stable), like nonzero(~seen, size=p)
    missing = torch.argsort(seen.to(torch.int8), dim=-1, stable=True).to(order.dtype)
    take = torch.clamp(torch.arange(p, device=order.device) - p_live, 0, p - 1)
    return torch.where(valid_pos, order, torch.take_along_dim(missing, take, dim=-1))


def _each(fn, *ts):
    """``fn`` applied to each matrix of a leading dataset axis, the results
    stacked (tuples of results stacked field by field); a plain call
    without one. Keeps every dataset's rounding independent of its batch."""
    if ts[0].ndim == 2:
        return fn(*ts)
    outs = [fn(*args) for args in zip(*ts)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(field) for field in zip(*outs))
    return torch.stack(outs)


def _cholesky_ladder(corr, base):
    """Cholesky of ``corr`` + ridge, escalating the ridge 1e-10 -> 1e-6 ->
    1e-4 (times ``base``) only where the factorization failed. All three
    factorizations run and a select picks, so the host never waits on the
    failure flag. With a leading dataset axis each dataset escalates on its
    own failure only: one dataset's ill-conditioning never moves another's
    jitter."""
    eye = torch.eye(corr.shape[-1], dtype=corr.dtype, device=corr.device)
    base = per_dataset(base, corr.ndim)

    def failed_of(chol, info):
        return per_dataset((info != 0) | torch.isnan(chol).any(dim=(-2, -1)), corr.ndim)

    chol, info = _each(torch.linalg.cholesky_ex, corr + (JITTER_SCALE * base) * eye)
    failed = failed_of(chol, info)
    for scale in (1e-6, 1e-4):
        retry, rinfo = _each(torch.linalg.cholesky_ex, corr + (scale * base) * eye)
        chol = torch.where(failed, retry, chol)
        failed = torch.where(failed, failed_of(retry, rinfo), failed)
    return chol


def adjacency_from_order(x, order, mask=None, n_valid=None,
                         prune_below: float = 0.0):
    """B (p, p) and noise variances Omega (p,) from raw samples ``x: (p, n)``
    and a *permutation* ``order`` (see :func:`complete_order` for padded
    buffers). Returns ``(b, omega)`` in original variable ids; the hard
    threshold ``prune_below`` zeroes spurious small edges."""
    p, n = x.shape[-2:]
    order = order.long()
    # rows in causal order; padded rows last
    xo = torch.take_along_dim(x, order[..., None], dim=-2)

    # Centered covariance on the true sample count; padded columns stay 0.
    smask = sample_mask(n, n_valid, x.device)
    if smask is None:
        xc = xo - torch.mean(xo, dim=-1, keepdim=True)
    else:
        mean_den = per_dataset(_sample_count(n_valid, n), x.ndim)
        mu = torch.sum(torch.where(smask, xo, 0.0), dim=-1, keepdim=True) / mean_den
        xc = torch.where(smask, xo - mu, 0.0)
    cov_den = _sample_count(n_valid, n, 1)
    var = torch.sum(torch.square(xc), dim=-1) / per_dataset(cov_den, x.ndim - 1)
    std = torch.sqrt(torch.clamp(var, min=VAR_EPS))  # dead rows -> sqrt(VAR_EPS)
    xs = xc / std[..., None]
    with full_precision_matmul():
        corr = _each(lambda m: m @ m.mT, xs) / per_dataset(cov_den, x.ndim)

    trace = torch.diagonal(corr, dim1=-2, dim2=-1).sum(dim=-1)
    if mask is None:
        p_live, base = p, trace / max(p, 1)
    else:
        p_live = torch.sum(mask, dim=-1)
        base = trace / torch.clamp(p_live, min=1)
    chol = _cholesky_ladder(corr, base)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    a_r = chol / diag[..., None, :]  # unit lower triangular
    eye = torch.eye(p, dtype=corr.dtype, device=x.device)
    a_r_inv = torch.linalg.solve_triangular(a_r, eye.expand_as(a_r), upper=False,
                                            unitriangular=True)
    # Undo the std scaling: A = D A_R D^{-1}  =>  A^{-1} = D A_R^{-1} D^{-1}.
    b_ord = eye - a_r_inv * (std[..., :, None] / std[..., None, :])
    omega_ord = torch.square(diag * std)
    if mask is not None:
        pos_live = torch.arange(p, device=x.device) < p_live[..., None]
        b_ord = torch.where(pos_live[..., :, None] & pos_live[..., None, :], b_ord, 0.0)
        omega_ord = torch.where(pos_live, omega_ord, 0.0)
    if prune_below > 0.0:
        b_ord = torch.where(torch.abs(b_ord) < prune_below, 0.0, b_ord)

    # b[order[a], order[c]] = b_ord[a, c], as a gather by the inverse order.
    inv = torch.argsort(order, dim=-1)
    b = torch.take_along_dim(b_ord, inv[..., :, None], dim=-2)
    b = torch.take_along_dim(b, inv[..., None, :], dim=-1)
    return b, torch.take_along_dim(omega_ord, inv, dim=-1)


def estimate_adjacency(x, order, prune_below: float = 0.0, *, config=None, device=None):
    """Phase 2 on its own for a full, unpadded dataset (``pruning.
    estimate_adjacency``'s signature): B only. ``x`` and ``order`` (numpy or
    torch) move to ``device``: the card unless the caller passes
    ``device="cpu"``, as for ``paralingam.fit``. B comes in ``config.dtype``
    where a ``ParaLiNGAMConfig`` is given, else in ``x``'s dtype where that
    is float32 or float64 (numpy or torch), else in float32.
    :func:`adjacency_from_order` gives (B, Omega) and takes padded buffers."""
    from repro_torch.core.paralingam import DTYPES, _device  # paralingam imports this module

    dev = _device(device, "estimate_adjacency")
    if config is not None:
        dtype = config.dtype
    else:
        dtype = DTYPES.get(str(getattr(x, "dtype", "")).removeprefix("torch."), torch.float32)
    x = torch.as_tensor(x, dtype=dtype, device=dev)
    b, _ = adjacency_from_order(x, torch.as_tensor(order, dtype=torch.int64, device=dev),
                                prune_below=prune_below)
    return b

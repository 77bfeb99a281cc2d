"""ICA-LiNGAM (Shimizu et al. 2006) — the paper's other baseline.

Port of ``src/repro/core/ica_lingam.py``. FastICA (symmetric, log-cosh
contrast) in torch ops, followed by the LiNGAM post-processing: row-permute
the unmixing matrix to a dominant diagonal, rescale, B = I - W, and extract
a causal order by greedily permuting B towards strict lower-triangularity.
The post-processing is numpy code in both packages; it is copied as it is.

DirectLiNGAM (and thus ParaLiNGAM) exists precisely because this estimator
can get stuck in local optima and is scale-sensitive (paper Section 2.3);
it is included for completeness of the paper's baseline set.

The fixed-point loop is the reference's ``lax.while_loop`` as a Python loop
with the same test (``delta > tol`` and ``it < max_iter``): one host read of
``delta`` per iteration. Its float32 products run at full precision (TF32
off, ``covariance.full_precision_matmul``). The random start is a normal
(p, p) draw from an explicit ``torch.Generator``; ``w0`` takes a given draw
instead, so tests can carry the reference's ``jax.random.normal(key, (p,
p))`` across the way weights are carried across.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.covariance import full_precision_matmul
from repro_torch.core.paralingam import _device


def _whiten(x):
    """x: (p, n) centered -> (z, whitener) with cov(z) = I."""
    n = x.shape[1]
    cov = (x @ x.T) / (n - 1)
    vals, vecs = torch.linalg.eigh(cov)
    vals = torch.clamp(vals, min=1e-10)
    k = (vecs * torch.rsqrt(vals)[None, :]) @ vecs.T
    return k @ x, k


def _sym_decorrelate(w):
    vals, vecs = torch.linalg.eigh(w @ w.T)
    vals = torch.clamp(vals, min=1e-12)
    inv_sqrt = (vecs * torch.rsqrt(vals)[None, :]) @ vecs.T
    return inv_sqrt @ w


def _fast_ica(x, generator=None, max_iter: int = 500, tol: float = 1e-6, *, w0=None,
              device=None):
    """:func:`fast_ica` and the number of fixed-point iterations it ran."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    dev = _device(device, "repro_torch.core.ica_lingam.fast_ica")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    p, n = x.shape
    with full_precision_matmul():
        xc = x - x.mean(dim=1, keepdim=True)
        z, k = _whiten(xc)
        if w0 is None:
            gen = generator or torch.Generator(device=dev).manual_seed(0)
            w0 = torch.randn((p, p), generator=gen, device=gen.device)
        w = _sym_decorrelate(torch.as_tensor(w0, dtype=torch.float32, device=dev))
        delta, it = torch.ones((), device=dev), 0
        while it < max_iter and bool(delta > tol):  # compared in float32, as there
            wz = w @ z  # (p, n)
            g = torch.tanh(wz)
            g_prime = 1.0 - torch.square(g)
            w_new = (g @ z.T) / n - torch.mean(g_prime, dim=1, keepdim=True) * w
            w_new = _sym_decorrelate(w_new)
            delta = torch.max(torch.abs(torch.abs(torch.sum(w_new * w, dim=1)) - 1.0))
            w, it = w_new, it + 1
        return w @ k, it  # unmixing in the original (centered) coordinates


def fast_ica(x, generator=None, max_iter: int = 500, tol: float = 1e-6, *, w0=None,
             device=None):
    """x: (p, n) raw. Returns the (p, p) float32 unmixing matrix W with
    S = W X, on the device: the given one, else that of a tensor ``x``, else
    the card (``device="cpu"`` runs on the CPU).

    ``generator`` draws the random start (a ``torch.Generator`` on the
    device; None: one seeded with 0); ``w0`` is that (p, p) draw given
    instead, before its symmetric decorrelation."""
    return _fast_ica(x, generator, max_iter, tol, w0=w0, device=device)[0]


def _permute_dominant_diagonal(w: np.ndarray) -> np.ndarray:
    """Greedy assignment maximizing |diag| (Hungarian-lite)."""
    p = w.shape[0]
    cost = 1.0 / (np.abs(w) + 1e-12)
    perm = np.full(p, -1)
    used_rows, used_cols = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(cost, axis=None), cost.shape))[0]
    for r, c in order:
        if r not in used_rows and c not in used_cols:
            perm[c] = r
            used_rows.add(r)
            used_cols.add(c)
    return w[perm]


def _causal_order_from_b(b: np.ndarray) -> list[int]:
    """Greedy: repeatedly take the variable with least incoming mass from
    the unresolved set (approximate strict-lower-triangular permutation)."""
    p = b.shape[0]
    remaining = list(range(p))
    order = []
    babs = np.abs(b)
    while remaining:
        sub = babs[np.ix_(remaining, remaining)]
        incoming = sub.sum(axis=1)
        k = int(np.argmin(incoming))
        order.append(remaining.pop(k))
    return order


def ica_lingam(x, generator=None, prune_below: float = 0.05, *, w0=None, device=None):
    """Full ICA-LiNGAM: returns (causal_order, B_est), B a numpy array.
    FastICA runs on ``device`` (see :func:`fast_ica`), the rest on the host."""
    w = fast_ica(x, generator, w0=w0, device=device).cpu().numpy()
    w = _permute_dominant_diagonal(w)
    w = w / np.diag(w)[:, None]
    b = np.eye(w.shape[0]) - w
    order = _causal_order_from_b(b)
    # zero the upper triangle implied by the order (acyclicity projection)
    pos = {v: i for i, v in enumerate(order)}
    for i in range(b.shape[0]):
        for j in range(b.shape[0]):
            if pos[j] >= pos[i]:
                b[i, j] = 0.0
    if prune_below > 0:
        b[np.abs(b) < prune_below] = 0.0
    return order, b

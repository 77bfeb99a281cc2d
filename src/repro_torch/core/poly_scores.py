"""Pair-score moments as matrix products (the polynomial scorer).

Port of ``src/repro/core/poly_scores.py``. The Hyvarinen moments
E[log cosh u] and E[u exp(-u^2/2)] of the pair residual u_ij = a_ij x_i -
b_ij x_j (a = 1/sqrt(1-c^2), b = c a) are transcendental in u.
Approximating

    log cosh(u)      ~ sum_k alpha_k u^(2k)      (even, k <= K)
    u exp(-u^2/2)    ~ sum_k beta_k  u^(2k+1)    (odd)

turns every pair moment into a weighted sum of *cross power moments*

    G_{m,l} = (X^m) (X^l)^T / n        (elementwise powers, then matmul)

via the binomial expansion of (a x_i - b x_j)^t: ~30 (p, n) x (n, p)
products replace the p^2 n elementwise transcendental stream. The
approximation is not exact, so it is exposed as (a) an approximate mode
(:func:`poly_scores`) and (b) a *hybrid* mode (:func:`hybrid_find_root`)
that uses the approximate scores to pick top-K root candidates and rescores
only those exactly.

The products are plain ``torch.matmul`` in full float32
(``covariance.full_precision_matmul``: TF32 off), because terms up to
a^10 x^10 cancel. Coefficients are least-squares fits over u in [-8, 8]
weighted by a standard-normal-ish density (residuals are standardized),
computed once at import with numpy, as in the reference. The functions run
where their tensors lie.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from repro_torch.core.covariance import full_precision_matmul
from repro_torch.core.entropy import entropy, entropy_from_moments
from repro_torch.core.pairwise import (
    pair_stat_matrix,
    residual_entropy_block,
    row_entropies,
    scores_from_stats,
)

K_EVEN = 5  # log cosh ~ degree 10 (even powers 0..10)
K_ODD = 4  # u exp(-u^2/2) ~ degree 9 (odd powers 1..9)
MAX_POW = 10


def _fit_coeffs():
    u = np.linspace(-8.0, 8.0, 4001)
    # Residuals are standardized: weight the fit by where samples actually
    # land (Gaussian bulk; tails contribute O(P(|u|>5)) ~ 1e-6 to the mean).
    w = np.exp(-0.5 * u**2) + 1e-4
    sw = np.sqrt(w)

    logcosh = np.abs(u) + np.log1p(np.exp(-2 * np.abs(u))) - np.log(2.0)
    basis_e = np.stack([u ** (2 * k) for k in range(K_EVEN + 1)], axis=1)
    alpha, *_ = np.linalg.lstsq(basis_e * sw[:, None], logcosh * sw, rcond=None)

    uexp = u * np.exp(-0.5 * u**2)
    basis_o = np.stack([u ** (2 * k + 1) for k in range(K_ODD + 1)], axis=1)
    beta, *_ = np.linalg.lstsq(basis_o * sw[:, None], uexp * sw, rcond=None)
    return alpha, beta


ALPHA, BETA = _fit_coeffs()
_BINOM = np.zeros((MAX_POW + 1, MAX_POW + 1))
for _t in range(MAX_POW + 1):
    for _m in range(_t + 1):
        _BINOM[_t, _m] = _math.comb(_t, _m)


def cross_power_moments(xn):
    """G[m, l] = (X^m)(X^l)^T / n for the ~30 (m, l) pairs with
    m + l <= MAX_POW (filled symmetrically; unused entries stay zero).
    ``xn: (p, n)`` -> (MAX_POW + 1, MAX_POW + 1, p, p)."""
    p, n = xn.shape
    powers = [xn**m for m in range(MAX_POW + 1)]
    g = torch.zeros((MAX_POW + 1, MAX_POW + 1, p, p), dtype=xn.dtype, device=xn.device)
    with full_precision_matmul():
        for t in range(MAX_POW + 1):
            for m in range(t // 2 + 1):
                l = t - m
                gm = (powers[m] @ powers[l].T) / n
                g[m, l] = gm
                if l != m:
                    g[l, m] = gm.T
    return g


def _moment_from_poly(coeffs, parities, a, b, g):
    """sum_k coeffs[k] * E[(a x_i - b x_j)^t_k] with t_k = parities[k]."""
    out = torch.zeros_like(a)
    for k, t in enumerate(parities):
        acc = torch.zeros_like(a)
        for m in range(t + 1):
            l = t - m
            term = (
                float(_BINOM[t, m])
                * (a**m)
                * ((-b) ** l)
                * g[m, l]
            )
            acc = acc + term
        out = out + float(coeffs[k]) * acc
    return out


def poly_scores(xn, c, mask):
    """Approximate (S, I) via the power-moment formulation.

    |c| is clamped so a = 1/sqrt(1-c^2) <= ~3.2: near-collinear pairs would
    otherwise hit catastrophic cancellation in the binomial expansion
    (a^10 ~ 1e20 terms cancelling to O(1)). Such pairs are strongly
    *dependent* — never root candidates — and the hybrid mode rescores
    candidates exactly regardless."""
    a = torch.rsqrt(torch.clamp(1.0 - torch.square(c), min=0.1))
    b = c * a
    g = cross_power_moments(xn)
    m1 = _moment_from_poly(ALPHA, [2 * k for k in range(K_EVEN + 1)], a, b, g)
    m2 = _moment_from_poly(BETA, [2 * k + 1 for k in range(K_ODD + 1)], a, b, g)
    hr = entropy_from_moments(m1, m2)
    hx = row_entropies(xn, mask)
    stat = pair_stat_matrix(hx, hr)
    return scores_from_stats(stat, mask), stat


def hybrid_find_root(xn, c, mask, top_k: int = 8):
    """Approximate scores pick top-K candidates; only those rows are rescored
    exactly (elementwise) — exact argmin among candidates. Returns 0-dim
    tensors (root, its exact score).

    The candidates are the ``top_k`` lowest approximate scores, ties to the
    lower index (a stable sort: ``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise)."""
    p, n = xn.shape
    s_approx, _ = poly_scores(xn, c, mask)
    cand = torch.sort(s_approx, stable=True).indices[:top_k]  # (K,)

    # exact rescore of candidate rows: HR[cand, :] and HR[:, cand]
    x_cand = xn[cand]
    c_rows = c[cand, :]  # (K, p)
    hr_fwd = residual_entropy_block(x_cand, c_rows, xn)  # H(r_cand^(j)): (K, p)
    hr_rev_t = residual_entropy_block(xn, c[:, cand], x_cand)  # H(r_j^(cand)): (p, K)
    hx = entropy(xn, axis=-1)
    stat = (hx[None, :] - hx[cand][:, None]) + (hr_fwd - hr_rev_t.T)  # (K, p)
    valid = (mask[None, :] & mask[cand][:, None]
             & (cand[:, None] != torch.arange(p, device=xn.device)[None, :]))
    s_exact = torch.sum(
        torch.where(valid, torch.square(torch.clamp(stat, max=0.0)), 0.0), dim=1
    )
    s_exact = torch.where(mask[cand], s_exact, torch.inf)
    best = torch.argmin(s_exact)
    return cand[best], s_exact[best]

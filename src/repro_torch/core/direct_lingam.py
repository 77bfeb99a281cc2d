"""Sequential DirectLiNGAM (Algorithms 1-2 of the paper), as a numpy oracle.

This is the *literal*, per-pair-loop formulation: every residual is computed
from samples, re-standardized from samples, and every ordered pair (i, j)
evaluates the full likelihood-ratio test independently — i.e. exactly the
redundant work ParaLiNGAM removes. It serves two purposes:

  1. correctness oracle for the ParaLiNGAM torch path (bit-compatible causal
     orders are asserted in tests), and
  2. the "serial runtime" baseline of paper Table 2 / Fig. 4.

Kept in float64 numpy (only the scalar constants come from ``core.entropy``)
so the two implementations share no code paths.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.entropy import BETA, K1, K2  # scalar constants only

H_GAUSS = 0.5 * (1.0 + math.log(2.0 * math.pi))


def _entropy_np(u: np.ndarray) -> float:
    """Hyvarinen entropy approximation (paper Eq. 8) for standardized u."""
    a = np.abs(u)
    logcosh = a + np.log1p(np.exp(-2.0 * a)) - math.log(2.0)
    m1 = float(np.mean(logcosh))
    m2 = float(np.mean(u * np.exp(-0.5 * u * u)))
    return H_GAUSS - K1 * (m1 - BETA) ** 2 - K2 * m2**2


def _standardize_np(x: np.ndarray) -> np.ndarray:
    c = x - x.mean(axis=-1, keepdims=True)
    s = np.sqrt(np.maximum((c * c).sum(axis=-1, keepdims=True) / (x.shape[-1] - 1), 1e-12))
    return c / s


def find_root(x: np.ndarray, u_set: list[int], count_comparisons: bool = False):
    """FindRoot (Algorithm 2): per ordered pair regression + entropy test."""
    if len(u_set) == 1:
        return (u_set[0], 0) if count_comparisons else u_set[0]
    n = x.shape[1]
    scores = {i: 0.0 for i in u_set}
    comparisons = 0
    xs = {i: _standardize_np(x[i]) for i in u_set}
    hs = {i: _entropy_np(xs[i]) for i in u_set}
    for i in u_set:
        for j in u_set:
            if i == j:
                continue
            xi, xj = xs[i], xs[j]
            b_ij = float(xi @ xj) / (n - 1)  # cov of standardized rows
            r_i_j = xi - b_ij * xj
            r_j_i = xj - b_ij * xi
            r_i_j = _standardize_np(r_i_j)
            r_j_i = _standardize_np(r_j_i)
            stat = hs[j] + _entropy_np(r_i_j) - hs[i] - _entropy_np(r_j_i)
            scores[i] += min(0.0, stat) ** 2
            comparisons += 1
    best = min(u_set, key=lambda i: (scores[i], u_set.index(i)))
    return (best, comparisons) if count_comparisons else best


def regress_root(x: np.ndarray, u_set: list[int], root: int) -> np.ndarray:
    """RegressRoot (Algorithm 1 line 7): residualize remaining rows on root."""
    x = x.copy()
    xr = x[root]
    var_r = float(xr @ xr) / len(xr) - float(xr.mean()) ** 2
    var_r = max(var_r, 1e-12)
    for i in u_set:
        if i == root:
            continue
        cov_ir = float(np.cov(x[i], xr, ddof=1)[0, 1])
        x[i] = x[i] - (cov_ir / (var_r * len(xr) / (len(xr) - 1))) * xr
    return x


def causal_order(x: np.ndarray, count_comparisons: bool = False):
    """DirectLiNGAM step 1 (Algorithm 1): full causal order.

    ``x: (p, n)`` raw observations. Returns list of variable indices
    (optionally with the total ordered-pair comparison count)."""
    x = np.asarray(x, dtype=np.float64).copy()
    p = x.shape[0]
    u_set = list(range(p))
    order: list[int] = []
    total_comparisons = 0
    while u_set:
        root, comps = find_root(x, u_set, count_comparisons=True)
        total_comparisons += comps
        order.append(root)
        u_set.remove(root)
        if u_set:
            x = regress_root(x, u_set, root)
    if count_comparisons:
        return order, total_comparisons
    return order

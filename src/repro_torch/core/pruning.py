"""DirectLiNGAM step 2: estimate causal strengths B given a causal order.

The paper notes step 2 is "fairly fast since we are only performing linear
regressions"; we implement it in closed form. With variables arranged in
causal order, X = B X + N with B strictly lower triangular and Cov(N) = Omega
diagonal, so

    Sigma = (I - B)^{-1} Omega (I - B)^{-T}
          = A Omega A^T,             A := (I - B)^{-1}  (unit lower tri.)

and the Cholesky factor of Sigma is L = A Omega^{1/2}. Hence

    A = L diag(L)^{-1}      and      B = I - A^{-1}

— one Cholesky + one triangular solve, O(p^3) total, instead of p separate
regressions (O(p^4)). An optional hard threshold prunes spurious small edges.

This module is the float64 *numpy oracle*; the device-resident torch
implementation that ``fit`` runs behind the causal-order scan
lives in ``repro_torch.core.adjacency`` and is tested against these functions.
Both share the jitter policy below.
"""

from __future__ import annotations

import numpy as np

# Ridge-jitter scale for numerically singular sample covariances: the jitter
# added before the Cholesky is JITTER_SCALE * mean(diag variance). The single
# policy shared by estimate_adjacency, regression_residual_variances and the
# JAX path (core/adjacency.py applies the same scale on the correlation
# matrix, which is the identical ridge up to the per-variable std scaling).
JITTER_SCALE = 1e-10


def centered_cov_chol(x: np.ndarray, order) -> tuple[np.ndarray, np.ndarray]:
    """Shared phase-2 prologue: rows of ``x: (p, n)`` re-arranged in causal
    order, sample-centered, covariance formed and Cholesky-factored with the
    ridge jitter policy. Returns ``(xo_centered, chol)``.

    Single code path for :func:`estimate_adjacency` and
    :func:`regression_residual_variances` so the jitter policy cannot drift
    between the B matrix and the noise variances (mirrors the
    ``covariance.rank1_gates`` move for the phase-1 updates)."""
    x = np.asarray(x, np.float64)
    p = x.shape[0]
    xo = x[list(order)]
    xo = xo - xo.mean(axis=1, keepdims=True)
    sigma = (xo @ xo.T) / (x.shape[1] - 1)
    jitter = JITTER_SCALE * np.trace(sigma) / p
    chol = np.linalg.cholesky(sigma + jitter * np.eye(p))
    return xo, chol


def estimate_adjacency(x: np.ndarray, order: list[int], prune_below: float = 0.0) -> np.ndarray:
    """Estimate B (p, p) from raw samples ``x: (p, n)`` and a causal order."""
    p = np.asarray(x).shape[0]
    order = list(order)
    _, chol = centered_cov_chol(x, order)
    a = chol / np.diag(chol)[None, :]  # unit lower triangular
    a_inv = np.linalg.solve(a, np.eye(p))
    b_ord = np.eye(p) - a_inv
    if prune_below > 0.0:
        b_ord[np.abs(b_ord) < prune_below] = 0.0
    b = np.zeros_like(b_ord)
    b[np.ix_(order, order)] = b_ord
    return b


def regression_residual_variances(x: np.ndarray, order: list[int]) -> np.ndarray:
    """Diagonal of Omega (exogenous noise variances) in original variable ids."""
    p = np.asarray(x).shape[0]
    _, chol = centered_cov_chol(x, order)
    omega_ord = np.diag(chol) ** 2
    omega = np.zeros(p)
    omega[list(order)] = omega_ord
    return omega

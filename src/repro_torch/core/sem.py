"""LiNGAM structural-equation-model synthetic data generation.

Follows the paper's Section 5.4 procedure (itself following ICA-LiNGAM):

  * sparse graphs: #parents ~ U[1, 0.2 p]; dense: U[0.25 p, 0.5 p]
  * nonzero causal strengths ~ U([-0.95, -0.5] u [0.5, 0.95])
  * exogenous noise: Gaussian passed through a signed power nonlinearity
    with exponent ~ U([0.5, 0.8] u [1.2, 2.0])  (non-Gaussian by construction)
  * samples generated recursively in causal order, then variables randomly
    permuted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SemSpec:
    p: int
    n: int
    density: str = "sparse"  # "sparse" | "dense"
    seed: int = 0
    noise_scale: float = 1.0


def random_adjacency(p: int, density: str, rng: np.random.Generator) -> np.ndarray:
    """Strictly-lower-triangular causal strength matrix B (causal order =
    identity order; callers permute)."""
    b = np.zeros((p, p), dtype=np.float64)
    if density == "sparse":
        lo, hi = 1, max(1, int(0.2 * p))
    elif density == "dense":
        lo, hi = max(1, int(0.25 * p)), max(1, int(0.5 * p))
    else:
        raise ValueError(f"unknown density {density!r}")
    for i in range(1, p):
        k = int(rng.integers(lo, hi + 1))
        k = min(k, i)
        parents = rng.choice(i, size=k, replace=False)
        mag = rng.uniform(0.5, 0.95, size=k)
        sign = rng.choice([-1.0, 1.0], size=k)
        b[i, parents] = mag * sign
    return b


def _non_gaussian_noise(shape, rng: np.random.Generator, scale: float) -> np.ndarray:
    """Gaussian -> signed power nonlinearity (paper Section 5.4)."""
    z = rng.standard_normal(shape)
    p_var = shape[0] if len(shape) == 2 else 1
    lo_hi = np.where(
        rng.random(p_var) < 0.5,
        rng.uniform(0.5, 0.8, size=p_var),
        rng.uniform(1.2, 2.0, size=p_var),
    )
    q = lo_hi.reshape(-1, *([1] * (len(shape) - 1)))
    return scale * np.sign(z) * np.abs(z) ** q


def generate(spec: SemSpec):
    """Returns dict with:
      x        -- (p, n) float64 observation matrix (variables permuted)
      b_true   -- (p, p) causal strengths in the *permuted* variable ids
      order    -- a valid causal order over permuted variable ids
      perm     -- permutation applied (orig -> new position)
    """
    rng = np.random.default_rng(spec.seed)
    b = random_adjacency(spec.p, spec.density, rng)
    noise = _non_gaussian_noise((spec.p, spec.n), rng, spec.noise_scale)
    # X (in causal order) = (I - B)^{-1} N, computed recursively (B strictly lower).
    x = np.zeros_like(noise)
    for i in range(spec.p):
        x[i] = b[i, :i] @ x[:i] + noise[i]
    perm = rng.permutation(spec.p)
    # variable originally at row i now sits at row perm[i]
    x_perm = np.empty_like(x)
    x_perm[perm] = x
    b_perm = np.zeros_like(b)
    b_perm[np.ix_(perm, perm)] = b
    order = list(perm)  # orig causal order 0..p-1 maps to permuted ids
    return {"x": x_perm, "b_true": b_perm, "order": order, "perm": perm}


def is_valid_causal_order(order, b_true: np.ndarray) -> bool:
    """True iff no later variable in ``order`` causes an earlier one."""
    pos = {v: k for k, v in enumerate(order)}
    p = b_true.shape[0]
    for i in range(p):
        for j in range(p):
            if b_true[i, j] != 0 and pos[j] > pos[i]:
                return False
    return True

"""Hyvarinen's maximum-entropy approximation of differential entropy.

Paper Eq. (8) (Hyvarinen & Smith 2013, Hyvarinen 1998):

    H_hat(u) = H(nu) - k1 * (E[log cosh u] - beta)^2 - k2 * (E[u exp(-u^2/2)])^2

for a standardized (zero-mean, unit-variance) random variable ``u``, where
``H(nu) = (1 + log 2*pi) / 2`` is the entropy of a standard Gaussian.

The pairwise likelihood-ratio statistic of paper Eq. (7):

    I(x_i, x_j) = H(x_j) + H(r_i^(j)) - H(x_i) - H(r_j^(i))

is antisymmetric: ``I(i, j) = -I(j, i)`` — the redundancy the paper's
*messaging* mechanism exploits (Section 3.1).
"""

from __future__ import annotations

import math

import torch

# Constants from paper Eq. (8).
K1 = 79.047
K2 = 7.4129
BETA = 0.37457
H_GAUSS = 0.5 * (1.0 + math.log(2.0 * math.pi))


def log_cosh(u):
    """Numerically stable log(cosh(u)) = |u| + log1p(exp(-2|u|)) - log 2."""
    a = torch.abs(u)
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


def u_exp_moment(u):
    """Integrand of the second moment term: u * exp(-u^2 / 2)."""
    return u * torch.exp(-0.5 * torch.square(u))


def entropy_from_moments(m_logcosh, m_uexp):
    """H_hat given E[log cosh u] and E[u exp(-u^2/2)] (paper Eq. 8)."""
    return (
        H_GAUSS
        - K1 * torch.square(m_logcosh - BETA)
        - K2 * torch.square(m_uexp)
    )


def entropy(u, axis: int = -1):
    """H_hat(u) for standardized samples ``u`` along ``axis``."""
    m1 = torch.mean(log_cosh(u), dim=axis)
    m2 = torch.mean(u_exp_moment(u), dim=axis)
    return entropy_from_moments(m1, m2)

"""Plain torch oracles of the hand-written kernels that the JAX package keeps
in ``src/repro/kernels/ref.py``: the fused Algorithm 7 + 8 update and the
SSD decode step. Each kernel's own plain version lives beside its wrapper
(``covupdate.update_data_ref`` / ``update_cov_ref`` in the TPU kernels'
order of operations, ``ssd_decode.ssd_decode_ref``); this one is written
from the paper's formulas, independent of the kernels' arithmetic.
"""

from __future__ import annotations

import torch

from repro_torch.core.covariance import VAR_EPS
from repro_torch.kernels.ssd_decode import ssd_decode_ref  # noqa: F401


def update_data_cov_ref(x, c, b, x_root):
    """Fused Algorithm 7 + 8 reference.

    x: (p, n) normalized rows; c: (p, p); b: (p,) = c[:, root] with the root
    (and dead rows) zeroed by the caller; x_root: (n,) the root's row.
    Returns (x_new, c_new), the diagonal of c_new restored to 1.
    """
    s = torch.sqrt(torch.clamp(1.0 - torch.square(b), min=VAR_EPS))
    x_new = (x - b[:, None] * x_root[None, :]) / s[:, None]
    c_new = (c - torch.outer(b, b)) / torch.outer(s, s)
    eye = torch.eye(c.shape[0], dtype=torch.bool, device=c.device)
    return x_new, torch.where(eye, 1.0, c_new)

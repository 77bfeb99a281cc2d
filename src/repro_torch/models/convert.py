"""Parameters carried across from the JAX package.

:func:`params_from_numpy` takes the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, repro.models.lm.init_params(...))``)
and returns the port's: the same nested dicts with torch tensors, the
leading group axis that ``jax.vmap(init_group)`` stacks
(``src/repro/models/lm.py:127``) unstacked into a list of per-group dicts,
each with every position of the group (``pos0`` ... ``pos5`` for gemma3,
``pos0`` ... ``pos6`` for zamba2) and its attention, MLP and SSM leaves;
unstacked trees (``embed``, ``final_norm``, Zamba2's ``shared`` block) keep
their shape. bfloat16 leaves go through float32 (exact). Tests run both
packages on the same weights through it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.paralingam import _device
from repro_torch.models import lm


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, cfg, device=None):
    """The port's parameters from the JAX package's tree of numpy arrays,
    on ``device`` (the card unless ``device="cpu"``)."""
    lm._check_ported(cfg)
    dev = _device(device, "repro_torch.models.convert.params_from_numpy")
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items() if k != "groups"}
    stacked = tree["groups"]
    out["groups"] = [_map(stacked, lambda a, g=g: _tensor(np.asarray(a)[g], dev))
                     for g in range(cfg.n_groups)]
    return out

"""Parameters and optimizer state carried across from the JAX package.

:func:`params_from_numpy` takes the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, repro.models.lm.init_params(...))``)
and returns the port's: the same nested dicts with torch tensors, the
leading group axis that ``jax.vmap(init_group)`` stacks
(``src/repro/models/lm.py:127``) unstacked into a list of per-group dicts,
each with every position of the group (``pos0`` ... ``pos5`` for gemma3,
``pos0`` ... ``pos6`` for zamba2) and its attention, MLA, MLP, MoE (the
(E, D, F) expert stacks, the router, the shared experts), SSM and
cross-attention leaves, and whisper's stacked encoder layers
(``enc_groups``, ``lm.py:144``) unstacked into a list of per-layer dicts;
unstacked trees (``embed``, ``final_norm``, Zamba2's ``shared`` block,
deepseek's ``prologue0``, ``enc_norm``, ``enc_pos``) keep their shape.
bfloat16 leaves go through float32 (exact). :func:`opt_state_from_numpy`
does the same for ``repro.train.optimizer.init_opt_state``'s ``{"m", "v",
"step"}``. Tests run both packages on the same weights and state through
them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.paralingam import _device


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked, n, dev):
    return [_map(stacked, lambda a, g=g: _tensor(np.asarray(a)[g], dev)) for g in range(n)]


def params_from_numpy(tree, cfg, device=None):
    """The port's parameters from the JAX package's tree of numpy arrays,
    on ``device`` (the card unless ``device="cpu"``)."""
    dev = _device(device, "repro_torch.models.convert.params_from_numpy")
    stacked = {"groups": cfg.n_groups, "enc_groups": cfg.n_enc_layers}
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items() if k not in stacked}
    for k, n in stacked.items():
        if k in tree:
            out[k] = _unstack(tree[k], n, dev)
    return out


def opt_state_from_numpy(state, cfg, device=None):
    """The port's optimizer state (``train.optimizer.init_opt_state``'s
    layout: float32 ``m`` and ``v`` shaped as the parameters, an int64
    ``step``) from the JAX package's as numpy arrays."""
    dev = _device(device, "repro_torch.models.convert.opt_state_from_numpy")
    return {"m": params_from_numpy(state["m"], cfg, dev),
            "v": params_from_numpy(state["v"], cfg, dev),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int64, device=dev)}

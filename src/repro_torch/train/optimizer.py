"""AdamW with a warmup + cosine schedule and global-norm clipping, as plain
functions over the parameter tree.

Port of ``src/repro/train/optimizer.py:23-96``, its semantics kept:

* the gradients are clipped by their global norm (``clip_norm``);
* ``m`` and ``v`` are float32 and bias-corrected;
* the step is ``mhat / (sqrt(vhat) + eps)``, plus decoupled weight decay
  on matrices only (``ndim >= 2``);
* everything is computed in float32 and cast back to the parameter's dtype.

A leaf's rank is the one it has in the reference's stacked tree
(``utils.tree.stacked_ndims``): a group's norm scale, a vector in the
port's list of groups, is a (G, d) matrix in the reference's and decays
there, so it decays here too.

``torch.optim.AdamW`` differs (it decays before the step and adds ``eps``
to the uncorrected root), so it is not used. ``adamw_update`` updates the
parameters, ``m``, ``v`` and ``step`` in place (call it under
``torch.no_grad()``), with ``torch._foreach_*`` ops over chunks of leaves
of at most ``CHUNK_NUMEL`` elements, so that its float32 temporaries stay
small beside the state. Every elementwise step rounds as the reference's
does, one operation at a time.

The reference's ZeRO-1 helpers (``zero1_spec_for``, ``zero1_specs``,
``opt_state_specs``) map PartitionSpecs for ``launch/specs.py``; they come
with the sharding specs (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.tree import stacked_ndims, tree_leaves, tree_map

#: Elements of the leaves one group of ``_foreach`` ops updates at a time.
CHUNK_NUMEL = 1 << 28


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptimizerConfig, step):
    """Linear warmup then cosine decay to min_lr_frac * lr (float32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params):
    """float32 ``m`` and ``v`` of the parameters' shapes, and the step (int64)."""
    first = tree_leaves(params)[0]
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "step": torch.zeros((), dtype=torch.int64, device=first.device),
    }


def global_norm(tree):
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _chunks(n_leaves, numel):
    """Index lists of consecutive leaves, each list under ``CHUNK_NUMEL``
    elements (a larger leaf alone)."""
    out, cur, size = [], [], 0
    for i in range(n_leaves):
        if cur and size + numel[i] > CHUNK_NUMEL:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += numel[i]
    return out + ([cur] if cur else [])


def adamw_update(cfg: OptimizerConfig, params, grads, opt_state):
    """One AdamW step. Updates ``params``, ``opt_state["m"]``, ``["v"]`` and
    ``["step"]`` in place and returns (params, opt_state, metrics), metrics
    ``{"grad_norm", "lr"}`` (device scalars). ``grads`` are read, not
    written."""
    step = opt_state["step"].add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_m, flat_v = tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])
    ranks = stacked_ndims(params)
    for idx in _chunks(len(flat_p), [p.numel() for p in flat_p]):
        p = [flat_p[i] for i in idx]
        m, v = [flat_m[i] for i in idx], [flat_v[i] for i in idx]
        g = torch._foreach_mul([flat_g[i].float() for i in idx], scale)
        torch._foreach_mul_(m, cfg.b1)  # m = b1 * m + (1 - b1) * g
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(g, g)  # v = b2 * v + (1 - b2) * g^2
        torch._foreach_mul_(g, 1 - cfg.b2)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, g)
        delta = torch._foreach_div(m, bc1)  # mhat / (sqrt(vhat) + eps)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(delta, denom)
        del g, denom
        p32 = [t.float() for t in p]  # the parameter itself when float32
        mat = [j for j, i in enumerate(idx) if ranks[i] >= 2]  # decay matrices only
        if mat:
            decay = torch._foreach_mul([p32[j] for j in mat], cfg.weight_decay)
            torch._foreach_add_([delta[j] for j in mat], decay)
            del decay
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(p32, delta)
        for t, t32 in zip(p, p32):
            if t32 is not t:
                t.copy_(t32)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}

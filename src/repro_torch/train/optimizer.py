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

Sharded (``rules`` with a mesh, ``specs`` the parameters' sharding
specs, ``lm.param_specs``): the parameters and gradients are this rank's
shards, and the gradients already averaged over the batch ranks.

* The clipping norm is the full gradient's: the squared sums of the
  leaves sharded over ``model`` are summed over the model ranks, and the
  replicated leaves counted once.
* ZeRO-1 (the reference's ``zero1_spec_for``, ``zero1_specs`` and
  ``opt_state_specs``, ported verbatim; the first two live in
  ``dist.sharding``, which FSDP shares them with): on a mesh with
  data-parallel dimensions (``pod``, ``data``) of size > 1, ``m`` and
  ``v`` hold this rank's slice of each leaf along the first dimension the
  spec leaves whole and the data ranks divide (``zero1_layout``). Each
  rank updates its slice of ``m``, ``v`` and the parameter, then
  all-gathers the parameter over the data ranks.
* FSDP (``specs`` the FSDP specs, ``dist.sharding.fsdp_specs``): a leaf
  sharded over ``data`` is its own ZeRO-1 slice. Its ``m`` and ``v`` take
  its spec unchanged (``zero1_spec_for`` returns a spec that names
  ``data`` as it is), it is updated in place, and nothing gathers it.
* Weight decay and the bfloat16 cast read the full leaf's stacked rank,
  which a shard keeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.dist.sharding import (
    NO_SHARDING,
    P,
    gather_shard,
    shard_axes,
    shard_bounds,
    sum_over,
    zero1_spec_for,  # noqa: F401 (the reference defines it here)
    zero1_specs,
)
from repro_torch.utils.tree import stacked_ndims, tree_leaves, tree_unflatten

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


def init_opt_state(params, specs=None, rules=NO_SHARDING):
    """float32 ``m`` and ``v`` (this rank's ZeRO-1 slice of each leaf when
    ``zero1_layout`` gives one) and the step (int64)."""
    first = tree_leaves(params)[0]
    layout = zero1_layout(params, specs, rules)

    def zeros():
        return tree_unflatten(params, [
            torch.zeros(_narrow(p, z, rules).shape, dtype=torch.float32, device=p.device)
            for p, z in zip(tree_leaves(params), layout)])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int64, device=first.device)}


def global_norm(tree, specs=None, rules=NO_SHARDING):
    """The 2-norm of every leaf of ``tree`` together. A leaf whose spec
    names the model axis, or FSDP's data dimensions, is a shard: its
    squared sum is summed over the ranks of those dimensions
    (``shard_axes``: the model ranks, the data ranks, or both), and a
    replicated leaf's is counted once."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if specs is None:
        if rules.model_axis is not None:
            raise ValueError("a norm under a model axis needs the leaves' specs")
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    over = [shard_axes(s, rules) for s in tree_leaves(specs)]
    if not any(over):
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    total = sum((q for q, names in zip(leaves, over) if not names), zero)
    for names in sorted(set(over) - {()}):
        part = sum((q for q, n in zip(leaves, over) if n == names), zero)
        total = sum_over(part, names, rules) + total
    return torch.sqrt(total)


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


def adamw_update(cfg: OptimizerConfig, params, grads, opt_state, *, specs=None,
                 rules=NO_SHARDING):
    """One AdamW step. Updates ``params``, ``opt_state["m"]``, ``["v"]`` and
    ``["step"]`` in place and returns (params, opt_state, metrics), metrics
    ``{"grad_norm", "lr"}`` (device scalars). ``grads`` are read, not
    written. Sharded: see the module's docstring; ``opt_state`` as
    ``init_opt_state(params, specs, rules)`` made it."""
    step = opt_state["step"].add_(1)
    gnorm = global_norm(grads, specs, rules)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    layout = zero1_layout(params, specs, rules)
    # the parameters and gradients this rank updates: its ZeRO-1 slices
    flat_p = [_narrow(p, z, rules) for p, z in zip(tree_leaves(params), layout)]
    flat_g = [_narrow(g, z, rules) for g, z in zip(tree_leaves(grads), layout)]
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
    for p, z in zip(tree_leaves(params), layout):
        if z is not None:  # every data rank's slice
            p.copy_(gather_shard(_narrow(p, z, rules), _only(z, p.ndim), rules))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of moments
# ---------------------------------------------------------------------------


def opt_state_specs(param_shapes, param_specs, mesh=None, zero1: bool = True,
                    data_axes=("pod", "data")):
    """The specs of ``init_opt_state``'s tree: ``m`` and ``v`` under
    ZeRO-1 (``zero1_specs``) when ``zero1`` and a mesh, the parameters'
    specs otherwise; ``step`` replicated."""
    moment = (
        zero1_specs(param_shapes, param_specs, mesh, data_axes)
        if (zero1 and mesh is not None)
        else param_specs
    )
    return {"m": moment, "v": moment, "step": P()}


def zero1_layout(params, specs, rules) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order): ``(dim, entry)``, the
    dimension along which ZeRO-1 slices its moments and the data axes it
    slices over, or None where the moments are whole, and for an FSDP
    leaf, whose moments are its shard. The parameters are this rank's
    shards: ``zero1_spec_for`` only picks a dimension their spec leaves
    whole, which a shard has at its full size."""
    leaves = tree_leaves(params)
    if rules.mesh is None or specs is None:
        return [None] * len(leaves)
    moments = opt_state_specs(params, specs, rules.mesh)["m"]
    out = []
    for p, ps, ms in zip(leaves, tree_leaves(specs), tree_leaves(moments)):
        ps = tuple(ps) + (None,) * (p.ndim - len(ps))
        ms = tuple(ms) + (None,) * (p.ndim - len(ms))
        dims = [d for d in range(p.ndim) if ms[d] != ps[d]]
        out.append((dims[0], ms[dims[0]]) if dims else None)
    return out


def _only(z, ndim: int) -> P:
    """The spec that slices dimension ``z[0]`` over ``z[1]`` alone."""
    return P(*[z[1] if d == z[0] else None for d in range(ndim)])


def _narrow(t, z, rules):
    if z is None:
        return t
    start, length = shard_bounds(rules, z[1], t.shape[z[0]])
    return t.narrow(z[0], start, length)

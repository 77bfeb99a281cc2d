"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, batched expert
GEMMs, an ordered combine, and shared experts.

Port of ``src/repro/models/moe.py``, the unsharded branch of ``moe_ffn``
(``rules.model_axis is None``). The reference's ``shard_map`` branch, with
experts sharded over the ``model`` axis, comes with the sharding specs
(ROADMAP.md queue 1 item 5); ``_moe_local`` keeps its ``e_lo`` / ``e_loc``
arguments so that branch can reuse it, and returns the partial output of
experts ``[e_lo, e_lo + e_loc)`` that the branch would sum over shards.

Points kept from the reference, in its order of operations:

* the router runs in float32 (``x.float() @ router``), then a float32
  softmax;
* the top k are taken by a stable descending sort, so that equal
  probabilities go to the lower expert index, as ``jax.lax.top_k`` breaks
  ties (``torch.topk`` guarantees no order);
* gates are divided by ``max(sum, 1e-9)``;
* dropless when T·k ≤ 256 (decode steps); otherwise each expert keeps the
  first ``ceil(T·k / E · capacity_factor)`` assignments in arrival order,
  token-major over the flattened (T·k) axis;
* dispatch scatters into an (E_loc·cap + 1, D) buffer whose last row is a
  dump row for the assignments dropped or owned by another shard;
* the expert GEMMs are batched over (E_loc, cap, D) in the weights' dtype;
* the combine multiplies by the gates cast to y's dtype, then adds each
  token's k contributions in k order. It is a loop, not ``index_add_``:
  on CUDA a floating-point ``index_add_`` uses atomics, whose order of
  adds changes from run to run;
* the load-balancing aux is ``E · mean(frac · pbar)``, ``frac`` from the
  first choice's one-hot.

There is no TPU kernel behind any of this: the reference computes it with
jnp ops, and the port with torch ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense


def init_moe(gen: torch.Generator, cfg, dtype):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    params = {
        "router": init_dense(gen, (d, e), d, torch.float32),
        "wi_gate": init_dense(gen, (e, d, f), d, dtype),
        "wi_up": init_dense(gen, (e, d, f), d, dtype),
        "wo": init_dense(gen, (e, f, d), f, dtype),
    }
    if cfg.n_shared_experts:
        fs = (cfg.d_ff_shared or cfg.d_ff_expert) * cfg.n_shared_experts
        params["shared"] = {
            "wi_gate": init_dense(gen, (d, fs), d, dtype),
            "wi_up": init_dense(gen, (d, fs), d, dtype),
            "wo": init_dense(gen, (fs, d), fs, dtype),
        }
    return params


def _act(gate, up, act: str):
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.silu(gate) * up


def capacity(t: int, cfg) -> int:
    """Slots per expert for ``t`` tokens: dropless (T·k) when T·k ≤ 256,
    else ``ceil(T·k / E · capacity_factor)``."""
    k = cfg.top_k
    if t * k <= 256:
        return t * k
    return max(1, math.ceil(t * k / cfg.n_experts * cfg.capacity_factor))


def route(router, x2d, k: int):
    """The float32 router over ``x2d: (T, D)``. Returns (probs (T, E),
    gates (T, k) normalized to sum 1, expert ids (T, k)), the ids in
    descending probability with ties to the lower index."""
    # float32 even when the trainer's compute copy holds a bfloat16 router:
    # the reference's float32 input promotes it.
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    top, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eids[:, :k]


def arrival(flat_e, e: int):
    """Each assignment's position within its expert, in arrival order over
    the flattened (T·k) axis: the exclusive cumsum of the one-hots."""
    onehot = F.one_hot(flat_e, e)
    prior = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(prior, 1, flat_e[:, None])[:, 0]


def _moe_local(params, x2d, cfg, e_lo: int, e_loc: int, n_shards: int):
    """Route + dispatch + expert GEMMs + combine for the local experts
    ``[e_lo, e_lo + e_loc)`` (``params``' expert weights hold those
    ``e_loc``; the router all ``E``). ``x2d: (T, D)``. Returns
    (partial_out, (frac, pbar)), the router statistics before their
    product, so that a sharded caller can reduce them first."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    probs, gates, eids = route(params["router"], x2d, k)

    oh = F.one_hot(eids[:, 0], e).float()
    stats = (oh.mean(0), probs.mean(0))

    flat_e = eids.reshape(-1)  # (T*K,), token-major
    flat_g = gates.reshape(-1)
    tok_idx = torch.arange(t, device=x2d.device).repeat_interleave(k)
    pos = arrival(flat_e, e)
    mine = (pos < cap) & (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    slot = torch.where(mine, (flat_e - e_lo) * cap + pos, e_loc * cap)  # dump row
    # Every slot but the dump row is written once; the dump row only zeros.
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[slot] = torch.where(mine[:, None], x2d[tok_idx], 0)
    h_in = buf[:-1].reshape(e_loc, cap, d)

    gate_h = torch.bmm(h_in, params["wi_gate"])
    up_h = torch.bmm(h_in, params["wi_up"])
    y = torch.bmm(_act(gate_h, up_h, cfg.act), params["wo"])

    y_flat = torch.cat([y.reshape(e_loc * cap, d), torch.zeros((1, d), dtype=y.dtype,
                                                               device=y.device)])
    g = torch.where(mine, flat_g, 0.0)[:, None].to(y.dtype)
    per_assign = (y_flat[slot] * g).reshape(t, k, d)
    out = torch.zeros_like(x2d)
    for j in range(k):  # each token's k contributions, in k order
        out = out + per_assign[:, j]

    if "shared" in params:
        sp = params["shared"]
        out = out + _act(x2d @ sp["wi_gate"], x2d @ sp["wi_up"], cfg.act) @ sp["wo"]
    return out, stats


def _aux_from_stats(frac, pbar, e):
    return e * torch.mean(frac * pbar)


def moe_ffn(params, x, cfg):
    """x: (B, S, D) -> (out, aux_loss), all experts on this device."""
    b, s, d = x.shape
    out, (frac, pbar) = _moe_local(params, x.reshape(-1, d), cfg, 0, cfg.n_experts, 1)
    return out.reshape(b, s, d), _aux_from_stats(frac, pbar, cfg.n_experts)

"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, batched expert
GEMMs, an ordered combine, and shared experts.

Port of ``src/repro/models/moe.py``, both branches of ``moe_ffn``:

* under a model axis (the reference's ``shard_map`` branch, expert
  parallelism) each model rank holds experts ``[e_lo, e_lo + E/M)`` and
  its columns of the shared experts, routes the tokens it has (every
  model rank alike), runs ``_moe_local`` on its experts, and the partial
  outputs are summed over the model ranks. With batch dimensions too,
  each batch rank routes its own rows, so the capacity comes from the
  local token count, and the router statistics ``frac`` and ``pbar`` are
  averaged over the batch ranks before their product;
* without a model axis and with batch dimensions (GSPMD's global view in
  the reference), each rank all-gathers the tokens over the batch ranks,
  routes the global batch (capacity and arrival order global) and keeps
  its own rows; without either, the single-device function.

Under context parallelism (``dist.sharding.context_parallel``) each model
rank holds its block of the sequence, and the MoE follows the reference's
``shard_map``, whose tokens enter replicated over ``model``: the rank
all-gathers its rows' tokens along the sequence (``gather_seq``), routes
them all, runs its experts and its shared-expert columns as above (no
tensor-parallel region: every model rank's loss reads the output), and
reduce-scatters the partial outputs along the sequence (``scatter_seq``:
the sum over the model ranks, this rank's block; its backward all-gathers
the blocks' gradients). The router statistics are those of the gathered
tokens, averaged over the batch ranks.

Under FSDP the weights arrive gathered with their layer (``lm._backbone``
gathers each layer's leaves over ``data`` where the layer runs:
``dist.sharding.gather_at_use``). ``fsdp_specs`` cuts an expert stack
(E, D, F) or (E, F, D), whose spec splits E over ``model``, along its
dimension 1, and the shared experts along the dimension ``model`` leaves
whole: the layout of the reference's explicit gather
(``src/repro/models/moe.py:136-161``, ``expert_spec = P("model", fsdp,
None)``). The gather's backward reduce-scatters their gradients inside
the layer's backward, so they leave it as this rank's shards and are
never materialised whole outside it, the failure the reference's comment
there records.

``_moe_local`` returns the partial output of experts ``[e_lo, e_lo +
e_loc)`` and the router statistics before their product. The routing runs
outside the tensor-parallel region (alike on every model rank), so the
router's gradient is whole there; the dispatch's inputs (the tokens and
their gates) enter the region.

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

from repro_torch.dist.sharding import (
    NO_SHARDING,
    P,
    context_parallel,
    copy_to_model,
    gather_batch,
    gather_seq,
    local_shard,
    mean_over_batch,
    model_index,
    reduce_from_model,
    scatter_seq,
)
from repro_torch.models.layers import init_dense, mlp_spec


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


def moe_spec(cfg):
    expert = P("model", None, None)
    spec = {"router": P(None, None), "wi_gate": expert, "wi_up": expert, "wo": expert}
    if cfg.n_shared_experts:
        spec["shared"] = mlp_spec((cfg.d_ff_shared or cfg.d_ff_expert) * cfg.n_shared_experts)
    return spec


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


def _moe_local(params, x2d, cfg, e_lo: int, e_loc: int, n_shards: int, enter=None):
    """Route + dispatch + expert GEMMs + combine for the local experts
    ``[e_lo, e_lo + e_loc)`` (``params``' expert weights hold those
    ``e_loc``; the router all ``E``). ``x2d: (T, D)``. Returns
    (partial_out, (frac, pbar)), the router statistics before their
    product, so that a sharded caller can reduce them first. ``enter``
    (a tensor-parallel region's entry) is applied to the tokens and their
    gates after the routing."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    probs, gates, eids = route(params["router"], x2d, k)

    oh = F.one_hot(eids[:, 0], e).float()
    stats = (oh.mean(0), probs.mean(0))
    if enter is not None:
        x2d, gates = enter(x2d), enter(gates)

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


def moe_ffn(params, x, cfg, rules=NO_SHARDING):
    """x: (B, S, D), this rank's rows -> (out, aux_loss). Without a model
    axis all experts are here (routed over the global batch when the
    batch is sharded); under one, this rank's block of them. Under context
    parallelism ``x`` is this rank's block of the sequence, and so is the
    output."""
    b, s, d = x.shape
    e = cfg.n_experts
    x2d = x.reshape(-1, d)
    if rules.model_axis is None:
        out, (frac, pbar) = _moe_local(params, gather_batch(x2d, rules), cfg, 0, e, 1)
        if rules.batch_shards > 1:  # this rank's rows of the global batch
            out = local_shard(out, P(tuple(rules.batch_axes)), rules)
        return out.reshape(b, s, d), _aux_from_stats(frac, pbar, e)
    n = rules.model_size
    e_loc = e // n
    if context_parallel(rules):
        whole = gather_seq(x, 1, rules)
        out, (frac, pbar) = _moe_local(params, whole.reshape(-1, d), cfg,
                                       model_index(rules) * e_loc, e_loc, n)
        out = scatter_seq(out.reshape(whole.shape), 1, rules)
        frac, pbar = mean_over_batch(frac, rules), mean_over_batch(pbar, rules)
        return out, _aux_from_stats(frac, pbar, e)
    out, (frac, pbar) = _moe_local(params, x2d, cfg, model_index(rules) * e_loc, e_loc, n,
                                   enter=lambda t: copy_to_model(t, rules))
    out = reduce_from_model(out, rules)
    # the router statistics over the batch ranks BEFORE their product
    frac, pbar = mean_over_batch(frac, rules), mean_over_batch(pbar, rules)
    return out.reshape(b, s, d), _aux_from_stats(frac, pbar, e)

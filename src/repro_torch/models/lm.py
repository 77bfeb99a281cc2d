"""Model assembler of the port: every family of the JAX package — dense
attention, sliding-window, MLA, MoE, SSM (Mamba2), hybrid (Zamba2) and
encoder-decoder (whisper).

Port of ``src/repro/models/lm.py``. Layers are organized into repeating
*groups*, as in the JAX package:

  dense (yi/granite/gemma-7b/chameleon):  group = [attn]
  gemma3:                                 group = [attn_w]*5 + [attn]
  llama4-scout:                           group = [attn_moe]
  deepseek-v2-lite:  prologue [mla],      group = [mla_moe]
  mamba2:                                 group = [ssm]
  zamba2:                                 group = [ssm]*6 + [hybrid_attn]
  whisper:  encoder layers [enc],         group = [xattn]

``hybrid_attn`` (Zamba2) is a *shared-weight* attention+MLP block: its
weights live once in ``params["shared"]``; each application has its own
2d->d input projection (``proj``) of the hidden state concatenated with the
embedding output. Leading dense layers (deepseek's first layer, a dense
MLA layer) are the *prologue*: ``params["prologue{i}"]`` and
``caches["prologue{i}"]``, run before the groups. Whisper's encoder
(``_encode``: learned positions ``enc_pos``, bidirectional attention,
``enc_norm``) runs over precomputed frame embeddings (B, enc_len, d_model);
each ``xattn`` layer adds cross-attention over its output (``ln_x``,
``xattn``), with no RoPE on the cross q/k.

The JAX package scans over stacked group parameters; the port keeps the
groups' structure but not the stack: ``params["groups"]`` (and whisper's
``params["enc_groups"]``) is a list with one dict per group (per encoder
layer), and ``_backbone`` is a Python loop over it. ``_backbone`` sums the
MoE layers' load-balancing aux; ``forward`` returns ``(logits, aux)`` as the
reference does, and ``train_loss`` adds ``aux_coef`` times the aux to the
token cross-entropy. Under ``cfg.remat`` a training forward
(``train=True``) recomputes activations in the backward
(``torch.utils.checkpoint``), in the reference's two-level sqrt-L split
(``_best_outer``) or per group. A training forward builds no caches: the
decode steps write K/V in place, which must never happen under autograd.

``param_specs`` and ``cache_specs`` give the reference's sharding specs
leaf for leaf (``dist.sharding.P``), without its stack axis: the groups'
specs are a list, as the groups are. Every entry point takes the
reference's ``rules``: each rank holds its rows of the batch and, under a
model axis, its shard of the weights (``init_params(rules=)`` slices each
layer as soon as it is drawn, split leaves by their parts), and the layers
run tensor-parallel over every kind (``layers``, ``attention``, ``moe``,
``ssm``, the encoder and the cross-attention here); ``train_loss`` is the
mean over the batch ranks. ``prefill`` and ``decode_step`` keep the
caches as ``cache_specs`` lays them out, split-KV: an attention or MLA
layer's cache holds every KV head of the rank's block of the sequence
(``dist.sharding.seq_slice``), an SSM layer's its heads' state and its
channels' conv tail, an ``xattn`` layer's cross K/V every KV head of every
encoder position; the logits are the rank's columns of the vocabulary.
``local_caches`` and ``gather_caches`` map a one-rank cache tree to a
rank's and back. Under FSDP (``rules.fsdp_axes``, training only) a leaf is
also cut over ``data`` (``param_specs(cfg, rules)``) and reaches the model
as a ``dist.sharding.FsdpShard``: each layer gathers its own where it runs
(``_backbone``, ``_encode``), and the embedding, the final norm and
whisper's ``enc_pos`` and ``enc_norm`` where they are read.

Under context parallelism (``dist.sharding.context_parallel``: the
reference's ``cp_seq`` train and prefill cells, every family but ``ssm``
and ``hybrid``) each rank takes the full ``(b_rank, S[+1])`` tokens it is
given and runs its block ``seq_block`` of the S positions, at their global
positions (``train_loss`` shifts first, then cuts: inputs ``[lo, hi)``,
labels ``[lo + 1, hi + 1)``). Each layer gathers its leaves whose specs
name ``model`` where it runs (``gather_at_use`` with ``_use_specs``: not
the MoE's experts and shared-expert columns, which stay local), and the
embedding and unembedding their tables, so the logits are the block's over
the whole vocabulary and the cross-entropy sums nothing over ``model``;
the loss is averaged over the model ranks (``mean_over_model``). Whisper's
encoder runs its block of ``enc_len`` where the model ranks divide it
(``_enc_cut``; else the whole on every rank), and each ``xattn`` layer
gathers its cross K/V along the encoder's positions. A prefill gives the
last position's logits, from the last model rank, on every rank, and the
caches split-KV as ``cache_specs`` lays them out; ``decode_step`` under
these rules runs as under tensor parallelism.

Entry points: ``init_params``, ``param_specs``, ``init_cache``,
``cache_specs``, ``local_caches``, ``gather_caches``, ``forward``,
``train_loss``, ``prefill``, ``decode_step``. They run where the
parameters are (``init_params`` puts them on the card unless asked for the
CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.paralingam import _device
from repro_torch.dist.sharding import (
    NO_SHARDING,
    P,
    ShardingRules,
    check_explicit,
    context_parallel,
    copy_to_model,
    decode_rules,
    fsdp_specs,
    gather_at_use,
    gather_over_model,
    gather_seq,
    gather_shard,
    local_rules,
    local_shard,
    mean_over_batch,
    mean_over_model,
    reduce_from_model,
    seq_block,
    seq_slice,
    shard_tree,
)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    NORM_SPEC,
    embed,
    embedding_spec,
    init_dense,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    mlp_spec,
    rmsnorm,
    softmax_xent,
    unembed,
)
from repro_torch.utils.tree import tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

#: Layer kinds whose cache is K/V (B, S, KV, dh), or its int8 form.
ATTN_KINDS = ("attn", "attn_w", "attn_moe", "hybrid_attn")
#: Layer kinds whose cache is MLA's (c_kv (B, S, r), k_rope (B, S, dr)).
MLA_KINDS = ("mla", "mla_moe")
#: Layer kinds with an MoE FFN in place of the MLP.
MOE_KINDS = ("attn_moe", "mla_moe")


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def group_layout(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.enc_dec:
        return ("xattn",)
    if cfg.family in ("ssm",):
        return ("ssm",)
    if cfg.family == "hybrid":
        return ("ssm",) * cfg.hybrid_attn_every + ("hybrid_attn",)
    if cfg.local_global_ratio > 0:
        return ("attn_w",) * cfg.local_global_ratio + ("attn",)
    if cfg.is_moe:
        return ("mla_moe" if cfg.mla else "attn_moe",)
    return ("mla" if cfg.mla else "attn",)


def prologue_layout(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.first_dense_layers:
        return ("mla" if cfg.mla else "attn",) * cfg.first_dense_layers
    return ()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, kind: str, cfg: ArchConfig, dtype):
    d = cfg.d_model
    params = {"ln1": init_rmsnorm(d, gen.device)}
    if kind == "ssm":
        params["ssm"] = ssm_mod.init_mamba2(gen, cfg, dtype)
        return params  # ssm blocks have no separate MLP
    if kind == "hybrid_attn":
        params["proj"] = init_dense(gen, (2 * d, d), 2 * d, dtype)
        return params  # block weights are shared (params["shared"])
    if kind in MLA_KINDS:
        params["attn"] = attn.init_mla(gen, cfg, dtype)
    else:  # attn, attn_w, attn_moe, enc, xattn
        params["attn"] = attn.init_attention(gen, cfg, dtype)
    if kind == "xattn":
        params["ln_x"] = init_rmsnorm(d, gen.device)
        params["xattn"] = attn.init_attention(gen, cfg, dtype)
    params["ln2"] = init_rmsnorm(d, gen.device)
    if kind in MOE_KINDS:
        params["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        params["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype)
    return params


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None,
                rules: ShardingRules = NO_SHARDING):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    the target device (the card unless ``device="cpu"``), at the JAX
    package's scales. ``dtype`` defaults to ``cfg.dtype``. With a mesh in
    ``rules`` every rank draws the same full weights, one layer at a time,
    and keeps only its shard of each (``param_specs(cfg, rules)``: under
    FSDP each leaf's FSDP spec, from its full shape): no rank holds the
    whole tree."""
    dev = _device(device, "repro_torch.models.lm.init_params")
    dtype = dtype or _DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = group_layout(cfg)
    specs = param_specs(cfg)

    def keep(tree, spec):
        return shard_tree(tree, fsdp_specs(tree, spec, rules), rules)

    params = {
        "embed": keep(init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype,
                                     cfg.tie_embeddings), specs["embed"]),
        "final_norm": keep(init_rmsnorm(cfg.d_model, dev), specs["final_norm"]),
        "groups": [{f"pos{i}": keep(_init_layer(gen, kind, cfg, dtype), gs[f"pos{i}"])
                    for i, kind in enumerate(layout)} for gs in specs["groups"]],
    }
    for i, kind in enumerate(prologue_layout(cfg)):
        params[f"prologue{i}"] = keep(_init_layer(gen, kind, cfg, dtype), specs[f"prologue{i}"])
    if cfg.family == "hybrid":
        params["shared"] = keep({"ln1": init_rmsnorm(cfg.d_model, dev),
                                 "attn": attn.init_attention(gen, cfg, dtype),
                                 "ln2": init_rmsnorm(cfg.d_model, dev),
                                 "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)},
                                specs["shared"])
    if cfg.enc_dec:
        params["enc_groups"] = [keep(_init_layer(gen, "enc", cfg, dtype), es)
                                for es in specs["enc_groups"]]
        params["enc_norm"] = keep(init_rmsnorm(cfg.d_model, dev), specs["enc_norm"])
        params["enc_pos"] = keep((torch.randn((cfg.enc_len, cfg.d_model), generator=gen,
                                              device=dev) * 0.02).to(dtype), specs["enc_pos"])
    return params


def _layer_spec(kind: str, cfg: ArchConfig):
    spec = {"ln1": NORM_SPEC}
    if kind == "ssm":
        spec["ssm"] = ssm_mod.mamba2_spec()
        return spec
    if kind == "hybrid_attn":
        spec["proj"] = P(None, None)
        return spec
    spec["attn"] = attn.mla_spec(cfg) if kind in MLA_KINDS else attn.attention_spec(cfg)
    if kind == "xattn":
        spec["ln_x"] = NORM_SPEC
        spec["xattn"] = attn.attention_spec(cfg)
    spec["ln2"] = NORM_SPEC
    if kind in MOE_KINDS:
        spec["moe"] = moe_mod.moe_spec(cfg)
    else:
        spec["mlp"] = mlp_spec(cfg.d_ff)
    return spec


def _use_specs(kind: str, cfg: ArchConfig):
    """The specs a layer's leaves are gathered by where it runs under
    context parallelism: ``_layer_spec``'s, with the MoE's leaves named
    whole (its experts and shared-expert columns stay this rank's)."""
    spec = _layer_spec(kind, cfg)
    if "moe" in spec:
        spec["moe"] = tree_map(lambda s: P(*(None,) * len(s)), spec["moe"])
    return spec


def _check_context_parallel(cfg: ArchConfig, rules: ShardingRules):
    """Refuse context parallelism for the families the reference keeps it
    off (``ssm`` and ``hybrid``: ``make_cell`` never sets it there)."""
    if context_parallel(rules) and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"context parallelism does not apply to {cfg.name} "
                                  f"({cfg.family})")


def param_shapes(cfg: ArchConfig):
    """The full shape (``torch.Size``) of every leaf of ``init_params``'
    tree, from a draw on fake tensors (nothing allocated)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    with detect_fake_mode() or FakeTensorMode():
        params = init_params(cfg, dtype=torch.float32, device="cpu")
    return tree_map(lambda t: t.shape, params)


def param_specs(cfg: ArchConfig, rules: ShardingRules = NO_SHARDING):
    """The sharding spec of every leaf of ``init_params``' tree, in its
    structure (the groups' specs a list): the reference's specs without
    their stack axis. Under FSDP (``rules.fsdp_axes``) the FSDP specs
    (``dist.sharding.fsdp_specs`` over ``param_shapes``), as the
    reference's train cell builds them."""
    if rules.fsdp_axes:
        return fsdp_specs(param_shapes(cfg), param_specs(cfg), rules)
    layout = group_layout(cfg)
    specs = {"embed": embedding_spec(cfg.tie_embeddings, cfg.vocab_padded),
             "final_norm": NORM_SPEC,
             "groups": [{f"pos{i}": _layer_spec(kind, cfg) for i, kind in enumerate(layout)}
                        for _ in range(cfg.n_groups)]}
    for i, kind in enumerate(prologue_layout(cfg)):
        specs[f"prologue{i}"] = _layer_spec(kind, cfg)
    if cfg.family == "hybrid":
        specs["shared"] = {"ln1": NORM_SPEC, "attn": attn.attention_spec(cfg), "ln2": NORM_SPEC,
                           "mlp": mlp_spec(cfg.d_ff)}
    if cfg.enc_dec:
        specs["enc_groups"] = [_layer_spec("enc", cfg) for _ in range(cfg.n_enc_layers)]
        specs["enc_norm"] = NORM_SPEC
        specs["enc_pos"] = P(None, None)
    return specs


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _cross_attention(lp, hx, cfg, enc_out, cache, cache_pos, rules=NO_SHARDING,
                     want_cache=True):
    """Cross-attention of an ``xattn`` layer: q from the decoder, K/V from
    the encoder output, no RoPE on either. At a decode step (``cache_pos``
    set) it reads the cached cross K/V (B, enc_len, KV, dh) through
    ``decode_attention`` with every encoder position valid; otherwise it
    projects ``enc_out`` and attends everywhere (``q_pos = enc_len``).
    Under a model axis the rank's q heads against the KV heads they read;
    the cross K/V (the cache) hold every KV head, replicated over
    ``model``. Under context parallelism every head of this rank's
    positions against the cross K/V, projected from the encoder's block
    where it is cut (``_enc_cut``) and gathered along the encoder's
    positions. Returns (out before ``wo``, (ck, cv))."""
    cut = cache_pos is None and _enc_cut(cfg, rules)
    seq_rules, rules = rules, (local_rules(rules) if cache_pos is None else rules)
    b, s, _ = hx.shape
    (q_lo, q_hi), (kv_lo, kv_hi) = attn.head_blocks(cfg, rules)
    q = attn._split_heads(copy_to_model(hx, rules) @ lp["wq"], q_hi - q_lo, cfg.head_dim)
    runs = attn.kv_runs(cfg, rules)
    if cache_pos is not None:
        ck, cv = cache
        k, v = attn.rank_kv(ck, cv, cfg, rules)
        enc_pos = torch.full((b,), ck.shape[1], dtype=torch.int64, device=hx.device)
        return attn.by_runs(attn.decode_attention, q, k, v, runs, enc_pos), (ck, cv)
    whole = rules.model_axis is None or not attn.kv_sharded(cfg)
    src = enc_out if whole else copy_to_model(enc_out, rules)
    n_kv = cfg.n_kv_heads if whole else kv_hi - kv_lo
    ck = attn._split_heads(src @ lp["wk"], n_kv, cfg.head_dim)
    cv = attn._split_heads(src @ lp["wv"], n_kv, cfg.head_dim)
    if cut:  # the encoder's blocks of positions, in order
        ck, cv = gather_seq(ck, 1, seq_rules), gather_seq(cv, 1, seq_rules)
    if whole:  # every KV head alike on every model rank; the rank reads its own
        k = copy_to_model(ck, rules)[:, :, kv_lo:kv_hi]
        v = copy_to_model(cv, rules)[:, :, kv_lo:kv_hi]
    else:
        k, v = ck, cv
        if want_cache:
            ck = gather_over_model(ck, 2, rules, cfg.n_kv_heads)
            cv = gather_over_model(cv, 2, rules, cfg.n_kv_heads)
    t = ck.shape[1]
    enc_positions = _positions(b, t, hx.device)
    q_pos = torch.full((b, s), t, dtype=torch.int64, device=hx.device)  # attend everywhere
    return attn.by_runs(attn.causal_attention, q, k, v, runs, q_pos, enc_positions), (ck, cv)


def _apply_layer(lp, kind, x, cfg, positions, rules=NO_SHARDING, *, shared=None, emb0=None,
                 enc_out=None, cache=None, cache_pos=None, want_cache=True):
    """One layer. Returns (x, new_cache_entry, aux), aux the MoE layer's
    load-balancing loss (None for other kinds). ``cache_pos`` set means a
    decode step over ``cache``; otherwise the layer runs the sequence and
    returns the cache it builds (an attention layer builds none unless
    ``want_cache``)."""
    if kind == "ssm":
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cache_pos is not None:
            out, new_state = ssm_mod.mamba2_decode(lp["ssm"], h, cfg, rules, cache)
        else:
            out, new_state = ssm_mod.mamba2_forward(lp["ssm"], h, cfg, rules)
        return x + out, new_state, None

    if kind == "hybrid_attn":
        h = torch.cat([x, emb0], dim=-1) @ lp["proj"]
        h = rmsnorm(h, shared["ln1"], cfg.norm_eps)
        out, new_kv = attn.attention_block(shared["attn"], h, cfg, positions, rules, window=0,
                                           kv_cache=cache, cache_pos=cache_pos,
                                           want_cache=want_cache)
        x = x + out
        h2 = rmsnorm(x, shared["ln2"], cfg.norm_eps)
        return x + mlp(shared["mlp"], h2, cfg.act, rules), new_kv, None

    tp = local_rules(rules)  # the MLP's and the cross-attention's sum (none under CP)
    if kind == "xattn":
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        out, new_self = attn.attention_block(
            lp["attn"], h, cfg, positions, rules, window=0,
            kv_cache=cache["self"] if cache is not None else None, cache_pos=cache_pos,
            want_cache=want_cache)
        x = x + out
        hx = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        out_x, new_cross = _cross_attention(
            lp["xattn"], hx, cfg, enc_out, cache["cross"] if cache is not None else None,
            cache_pos, rules, want_cache)
        out_x = out_x.reshape(*x.shape[:2], out_x.shape[2] * cfg.head_dim)
        x = x + reduce_from_model(out_x @ lp["xattn"]["wo"], tp)
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(lp["mlp"], h2, cfg.act, tp)
        new_cache = {"self": new_self, "cross": new_cross} if want_cache else None
        return x, new_cache, None

    # attention (MLA or GQA) + (mlp | moe)
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if kind in MLA_KINDS:
        out, new_kv = attn.mla_block(lp["attn"], h, cfg, positions, rules, kv_cache=cache,
                                     cache_pos=cache_pos, want_cache=want_cache)
    else:
        window = cfg.window if kind == "attn_w" else 0
        out, new_kv = attn.attention_block(lp["attn"], h, cfg, positions, rules, window=window,
                                           kv_cache=cache, cache_pos=cache_pos,
                                           want_cache=want_cache)
    x = x + out
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if kind in MOE_KINDS:
        out2, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg, rules)
        return x + out2, new_kv, aux
    return x + mlp(lp["mlp"], h2, cfg.act, tp), new_kv, None


def _enc_cut(cfg: ArchConfig, rules: ShardingRules) -> bool:
    """Whether a context-parallel rank runs its block of the encoder's
    ``enc_len`` positions (the model ranks divide them, as the reference's
    ``act`` spec cuts them), rather than the whole encoder."""
    return context_parallel(rules) and cfg.enc_len % rules.model_size == 0


def _encode(params, enc_in, cfg, rules=NO_SHARDING):
    """Whisper's encoder over frame embeddings ``enc_in: (B, T, d_model)``:
    learned positions ``enc_pos``, then per layer RoPE'd q/k through
    ``qkv`` and bidirectional attention (every position attends everywhere:
    ``q_pos = T``), the MLP, and ``enc_norm``. Under a model axis each
    layer runs the rank's heads and the MLP's columns, and their outputs
    are summed over ``model``. The frames are cast to the weights' dtype
    first (the reference lets a float32 input promote bfloat16 weights'
    products to float32; torch's products need one dtype). Under context
    parallelism every head with the layers' weights gathered, over this
    rank's block of the positions where the model ranks divide them
    (``_enc_cut``: K and V gathered along them), else over all of them;
    the output is that block."""
    pos = gather_at_use(params["enc_pos"], rules)
    t = enc_in.shape[1]
    lo, hi = 0, t
    if _enc_cut(cfg, rules):
        if t != cfg.enc_len:
            raise ValueError(f"{cfg.name}'s encoder input holds {t} positions, not {cfg.enc_len}")
        lo, hi = seq_block(t, rules)
    tp = local_rules(rules)
    x = enc_in[:, lo:hi].to(pos.dtype) + pos[None, lo:hi, :]
    b = x.shape[0]
    positions = _positions(b, t, x.device)
    q_pos = torch.full((b, hi - lo), t, dtype=torch.int64, device=x.device)
    specs = _use_specs("enc", cfg) if context_parallel(rules) else None
    for lp in params["enc_groups"]:
        lp = gather_at_use(lp, rules, specs)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv(lp["attn"], h, cfg, positions[:, lo:hi], tp)
        if hi - lo < t:
            k, v = gather_seq(k, 1, rules), gather_seq(v, 1, rules)
        out = attn.by_runs(attn.causal_attention, q, k, v, attn.kv_runs(cfg, tp), q_pos,
                           positions)
        out = out.reshape(b, hi - lo, q.shape[2] * cfg.head_dim) @ lp["attn"]["wo"]
        x = x + reduce_from_model(out, tp)
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(lp["mlp"], h2, cfg.act, tp)
    return rmsnorm(x, gather_at_use(params["enc_norm"], rules), cfg.norm_eps)


def _best_outer(g: int) -> int:
    """Divisor of g minimizing n_outer + g / n_outer (sqrt-L remat split)."""
    best, best_cost = 1, g + 1
    for d in range(1, g + 1):
        if g % d == 0:
            cost = d + g // d
            if cost < best_cost:
                best, best_cost = d, cost
    return best


#: ``aten`` ops whose outputs the ``"dots"`` remat policy saves: the
#: matrix products without batch dimensions, as
#: ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` (``x @ W``
#: reaches ``aten.mm``; the einsums of attention reach ``aten.bmm``).
_DOTS = ("mm", "addmm")


def _checkpoint(fn, policy: str):
    """``fn`` rematerialized in the backward: nothing saved inside it under
    the ``"nothing"`` and ``"default"`` policies, the no-batch matrix
    products' outputs under ``"dots"``."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    if policy not in ("nothing", "dots", "default"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {}
    if policy == "dots":
        saved = tuple(getattr(torch.ops.aten, n).default for n in _DOTS)

        def save_dots(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(save_dots)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _backbone(params, x, cfg, positions, rules=NO_SHARDING, *, caches=None, cache_pos=None,
              want_cache=False, enc_out=None, train=False):
    """Run the prologue layers, then the groups' layers, in order. Returns
    (x, new_caches, aux): new_caches has one entry per layer
    (``"prologue{i}"`` and ``"groups"``, as ``init_cache``), aux the sum of
    the MoE layers' load-balancing losses (float32). With ``cache_pos`` it
    is a decode step over ``caches``; otherwise the sequence runs and its
    caches are built if ``want_cache`` (``prefill``), else new_caches is
    None (``forward``). ``train`` with ``cfg.remat`` recomputes the groups
    in the backward: superblocks of ``G / _best_outer(G)`` groups each when
    ``cfg.scan_layers`` and ``_best_outer(G) > 1`` (the reference's
    two-level split), else each group on its own; the prologue is not
    recomputed, as in the reference.

    Under FSDP each layer's parameters (the shared block's at each of its
    applications) are gathered where the layer runs (``gather_at_use``):
    inside a recomputed superblock, so that the gathered copies live for
    its forward and are gathered again for its backward, as every rank
    does in the same order. Under context parallelism each layer's leaves
    whose specs name ``model`` are gathered over it there too
    (``_use_specs``)."""
    layout = group_layout(cfg)
    emb0 = x if cfg.family == "hybrid" else None
    shared = params.get("shared")
    want_cache = want_cache or cache_pos is not None
    if train and want_cache:
        raise ValueError("a training forward builds no caches")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {}
    cp = context_parallel(rules)
    for i, kind in enumerate(prologue_layout(cfg)):
        name = f"prologue{i}"
        x, new_caches[name], layer_aux = _apply_layer(
            gather_at_use(params[name], rules, _use_specs(kind, cfg) if cp else None), kind, x,
            cfg, positions, rules,
            cache=caches[name] if caches is not None else None, cache_pos=cache_pos,
            want_cache=want_cache)
        if layer_aux is not None:
            aux = aux + layer_aux

    def run_groups(x, aux, first, last):
        """Groups ``first`` to ``last - 1``; returns (x, aux, their caches)."""
        out = []
        for gi in range(first, last):
            new_cache = {}
            for i, kind in enumerate(layout):
                c = caches["groups"][gi][f"pos{i}"] if caches is not None else None
                x, new_cache[f"pos{i}"], layer_aux = _apply_layer(
                    gather_at_use(params["groups"][gi][f"pos{i}"], rules,
                                  _use_specs(kind, cfg) if cp else None), kind, x, cfg,
                    positions, rules,
                    shared=gather_at_use(shared, rules) if kind == "hybrid_attn" else None,
                    emb0=emb0, enc_out=enc_out, cache=c, cache_pos=cache_pos,
                    want_cache=want_cache)
                if layer_aux is not None:
                    aux = aux + layer_aux
            out.append(new_cache)
        return x, aux, out

    n_groups = len(params["groups"])
    if cfg.remat and train:
        n_outer = _best_outer(n_groups)
        n_inner = n_groups // n_outer if cfg.scan_layers and n_outer > 1 else 1
        block = _checkpoint(lambda x, aux, first: run_groups(x, aux, first, first + n_inner)[:2],
                            cfg.remat_policy)
        for first in range(0, n_groups, n_inner):
            x, aux = block(x, aux, first)
        return x, None, aux
    x, aux, new_caches["groups"] = run_groups(x, aux, 0, n_groups)
    return x, (new_caches if want_cache else None), aux


def _positions(b: int, s: int, device, start: int = 0):
    return torch.arange(start, start + s, device=device)[None, :].expand(b, s)


# ---------------------------------------------------------------------------
# full forward pass and the training loss
# ---------------------------------------------------------------------------


def _enc_out(params, enc_in, cfg, rules=NO_SHARDING):
    if not cfg.enc_dec:
        return None
    if enc_in is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: pass its encoder input "
                         f"(B, {cfg.enc_len}, {cfg.d_model}) as enc_in")
    return _encode(params, enc_in, cfg, rules)


def _table(params, name: str, cfg: ArchConfig, rules: ShardingRules) -> dict:
    """``{name: the embedding's leaf}`` gathered at use (FSDP, and under
    context parallelism whole over ``model``): the embedding reads
    ``tok``, the unembedding ``head`` or, tied, ``tok`` again, gathered a
    second time rather than kept through the backbone."""
    spec = embedding_spec(cfg.tie_embeddings, cfg.vocab_padded)[name]
    return {name: gather_at_use(params["embed"][name], rules,
                                spec if context_parallel(rules) else None)}


def _unembed_name(params) -> str:
    return "head" if "head" in params["embed"] else "tok"


def forward(params, tokens, cfg: ArchConfig, rules: ShardingRules = NO_SHARDING, positions=None,
            enc_in=None, train=False):
    """Full-sequence forward -> (logits (B, S, vocab_padded), aux), aux the
    MoE layers' summed load-balancing loss (0 without MoE). ``enc_in``:
    the encoder's frame embeddings of an encoder-decoder model. ``train``
    turns on ``cfg.remat``'s recompute. Under ``rules`` with a mesh,
    ``tokens`` are this rank's rows, and under a model axis the logits are
    this rank's columns of the vocabulary. Under FSDP the leaves that
    ``trainer.loss_and_grads`` hands in as ``FsdpShard``s are gathered
    where they are read. Under context parallelism ``tokens`` are this
    rank's rows whole, and the logits (B, S/M, vocab_padded) those of its
    block of positions (``seq_block``, at their global positions: no other
    ``positions`` are taken)."""
    check_explicit(rules)
    _check_context_parallel(cfg, rules)
    lo, hi = seq_block(tokens.shape[1], rules)
    if context_parallel(rules) and positions is not None:
        raise ValueError("context parallelism runs the block's own positions")
    return _forward(params, tokens[:, lo:hi], cfg, rules, positions, enc_in, train, lo)


def _forward(params, tokens, cfg, rules, positions=None, enc_in=None, train=False, start=0):
    """``forward`` over this rank's block of positions, ``tokens`` cut to
    it, the first at ``start``."""
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device, start)
    tp = local_rules(rules)
    x = embed(_table(params, "tok", cfg, rules), tokens, tp, cfg.vocab_padded)
    enc_out = _enc_out(params, enc_in, cfg, rules)
    x, _, aux = _backbone(params, x, cfg, positions, rules, enc_out=enc_out, train=train)
    x = rmsnorm(x, gather_at_use(params["final_norm"], rules), cfg.norm_eps)
    return unembed(_table(params, _unembed_name(params), cfg, rules), x, cfg.vocab, tp,
                   cfg.vocab_padded), aux


def train_loss(params, batch, cfg: ArchConfig, rules: ShardingRules = NO_SHARDING,
               aux_coef: float = 0.01):
    """batch: {"tokens": (B, S+1)} (+ "enc": (B, enc_len, D) for enc-dec).
    The mean next-token cross-entropy plus ``aux_coef`` times the MoE aux.
    Under ``rules`` with batch axes, ``batch`` is this rank's rows and the
    loss is the mean over the batch ranks (whose gradient is this rank's
    part: the trainer averages the gradients over the batch ranks). Under
    context parallelism the tokens are shifted, then cut to this rank's
    block (inputs ``[lo, hi)``, labels ``[lo + 1, hi + 1)``), and the
    block's loss is averaged over the model ranks as well."""
    check_explicit(rules)
    _check_context_parallel(cfg, rules)
    tokens = batch["tokens"]
    lo, hi = seq_block(tokens.shape[1] - 1, rules)
    inputs, labels = tokens[:, lo:hi], tokens[:, lo + 1:hi + 1]
    logits, aux = _forward(params, inputs, cfg, rules, enc_in=batch.get("enc"), train=True,
                           start=lo)
    loss = (softmax_xent(logits, labels, cfg.vocab, local_rules(rules), cfg.vocab_padded)
            + aux_coef * aux)
    return mean_over_batch(mean_over_model(loss, rules), rules)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int, dtype, device):
    if kind in MLA_KINDS:
        return (torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device),
                torch.zeros((batch, max_seq, cfg.rope_head_dim), dtype=dtype, device=device))
    if kind == "xattn":
        kv_shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        enc_kv = (batch, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)
        return {"self": (torch.zeros(kv_shape, dtype=dtype, device=device),
                         torch.zeros(kv_shape, dtype=dtype, device=device)),
                "cross": (torch.zeros(enc_kv, dtype=dtype, device=device),
                          torch.zeros(enc_kv, dtype=dtype, device=device))}
    if kind in ATTN_KINDS:
        kv_shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant == "int8":
            scale_shape = (batch, max_seq, cfg.n_kv_heads)
            return (torch.zeros(kv_shape, dtype=torch.int8, device=device),
                    torch.zeros(scale_shape, dtype=torch.bfloat16, device=device),
                    torch.zeros(kv_shape, dtype=torch.int8, device=device),
                    torch.zeros(scale_shape, dtype=torch.bfloat16, device=device))
        return (torch.zeros(kv_shape, dtype=dtype, device=device),
                torch.zeros(kv_shape, dtype=dtype, device=device))
    c = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return (torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, c), dtype=dtype, device=device))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Zero caches, one entry per layer, by layer kind: an attention layer's
    is K/V (B, max_seq, KV, dh) in ``dtype``, or with ``cfg.kv_quant ==
    "int8"`` the four-tuple (K int8, K scales (B, max_seq, KV) bf16, V, V
    scales); an MLA layer's is (c_kv (B, max_seq, r), k_rope (B, max_seq,
    dr)) in ``dtype`` whatever ``kv_quant`` says; an SSM layer's is (state
    (B, H, P, N) float32, conv tail (B, W-1, C)), with no sequence axis; an
    ``xattn`` layer's is ``{"self": (k, v), "cross": (ck, cv)}``, the cross
    K/V (B, enc_len, KV, dh). The prologue's layers have theirs under
    ``"prologue{i}"``."""
    dev = _device(device, "repro_torch.models.lm.init_cache")
    dtype = dtype or _DTYPES[cfg.dtype]
    layout = group_layout(cfg)
    caches = {f"prologue{i}": _layer_cache(kind, cfg, batch, max_seq, dtype, dev)
              for i, kind in enumerate(prologue_layout(cfg))}
    caches["groups"] = [{f"pos{i}": _layer_cache(kind, cfg, batch, max_seq, dtype, dev)
                         for i, kind in enumerate(layout)} for _ in range(cfg.n_groups)]
    return caches


def cache_specs(cfg: ArchConfig, rules: ShardingRules):
    """The sharding spec of every leaf of ``init_cache``'s tree, in its
    structure (split-KV: the sequence over the model axis), as the
    reference's without its stack axis."""
    b = tuple(rules.batch_axes) or None
    m = rules.model_axis

    def kind_spec(kind: str):
        if kind in ATTN_KINDS:
            s = P(b, m, None, None)
            if cfg.kv_quant == "int8":
                sc = P(b, m, None)
                return (s, sc, s, sc)
            return (s, s)
        if kind in MLA_KINDS:
            return (P(b, m, None), P(b, m, None))
        if kind == "ssm":
            return (P(b, m, None, None), P(b, None, m))
        if kind == "xattn":
            s = P(b, m, None, None)
            c = P(b, None, None, None)
            return {"self": (s, s), "cross": (c, c)}
        raise ValueError(kind)

    layout = group_layout(cfg)
    specs = {"groups": [{f"pos{i}": kind_spec(kind) for i, kind in enumerate(layout)}
                        for _ in range(cfg.n_groups)]}
    for i, kind in enumerate(prologue_layout(cfg)):
        specs[f"prologue{i}"] = kind_spec(kind)
    return specs


def _map_layers(caches, cfg: ArchConfig, fn):
    """``fn(kind, entry)`` over every layer's cache entry, in
    ``init_cache``'s structure."""
    layout = group_layout(cfg)
    out = {f"prologue{i}": fn(kind, caches[f"prologue{i}"])
           for i, kind in enumerate(prologue_layout(cfg))}
    out["groups"] = [{f"pos{i}": fn(kind, g[f"pos{i}"]) for i, kind in enumerate(layout)}
                     for g in caches["groups"]]
    return out


def _seq_block(t, max_seq: int, rules: ShardingRules):
    """A (B, S, ...) cache leaf of the whole sequence (S <= ``max_seq``) as
    this rank's block of a split-KV cache of ``max_seq`` positions, zeros
    past S; the whole, padded to ``max_seq``, without a model axis."""
    start, length = seq_slice(max_seq, rules)
    t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, max(start + length - t.shape[1], 0)))
    return t if (start, length) == (0, t.shape[1]) else t[:, start:start + length].contiguous()


def _grow_caches(caches, cfg: ArchConfig, max_seq: int, rules: ShardingRules = NO_SHARDING):
    """The caches with every attention layer's K/V (and int8 scales), every
    MLA layer's c_kv and k_rope and every ``xattn`` layer's self K/V, the
    prologue's too, grown with zeros along the sequence axis (axis 1 of
    each) to ``max_seq``, and under a model axis cut to this rank's block
    of it (split-KV); an SSM layer's cache has no sequence axis and an
    ``xattn`` layer's cross K/V spans the encoder's positions, and both
    stay as they are. (The reference pads whichever axis has the prompt's
    length, which picks an SSM state axis of equal size, an MLA cache's
    batch axis when B equals S, or a cross K/V's batch, head or head-dim
    axis.)"""

    def grow(kind, entry):
        if kind == "xattn":
            return {"self": grow("attn", entry["self"]), "cross": entry["cross"]}
        if kind not in ATTN_KINDS + MLA_KINDS:
            return entry
        return tuple(_seq_block(t, max_seq, rules) for t in entry)

    return _map_layers(caches, cfg, grow)


def local_caches(full, cfg: ArchConfig, rules: ShardingRules):
    """This rank's caches from a one-rank cache tree ``full`` (all rows,
    all heads, ``max_seq`` positions): its rows; an attention or MLA
    layer's block of the sequence (``seq_slice``: the last block is padded
    with zeros past ``max_seq``); an SSM layer's heads of the state and its
    channels of the conv tail (x's of its heads, then the whole B and C);
    an ``xattn`` layer's cross K/V whole."""
    rows = P(tuple(rules.batch_axes))

    def blocks(entry):
        return tuple(_seq_block(t, t.shape[1], rules) for t in entry)

    def cut(kind, entry):
        entry = tree_map(lambda t: local_shard(t, rows, rules), entry)
        if kind == "xattn":
            return {"self": blocks(entry["self"]), "cross": entry["cross"]}
        if kind == "ssm":
            state, tail = entry
            h_lo, h_hi = ssm_mod.ssm_head_block(cfg, rules)
            return (state[:, h_lo:h_hi].contiguous(),
                    ssm_mod._rank_channels(tail, cfg, rules).contiguous())
        return blocks(entry)

    return _map_layers(full, cfg, cut)


def gather_caches(local, cfg: ArchConfig, rules: ShardingRules, max_seq: int | None = None):
    """The one-rank cache tree from every rank's ``local_caches`` (or the
    caches its ``prefill`` and ``decode_step`` keep): a collective, every
    rank of the mesh calls it. A split-KV leaf's sequence comes back as the
    blocks' M·L positions, cut to ``max_seq`` when it is given."""
    rows = P(tuple(rules.batch_axes))

    def join(kind, entry):
        if kind == "xattn":
            return {"self": join("attn", entry["self"]), "cross": join("cross", entry["cross"])}
        if kind == "ssm":
            state, tail = entry
            di = tail.shape[2] - 2 * cfg.ssm_ngroups * cfg.ssm_state
            entry = (gather_over_model(state, 1, rules),
                     torch.cat([gather_over_model(tail[:, :, :di], 2, rules), tail[:, :, di:]], 2))
        elif kind != "cross":
            entry = tuple(gather_over_model(t, 1, rules)[:, :max_seq] for t in entry)
        return tuple(gather_shard(t, rows, rules) for t in entry)

    return _map_layers(local, cfg, join)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def prefill(params, tokens, cfg: ArchConfig, rules: ShardingRules = NO_SHARDING,
            max_seq: int | None = None, enc_in=None):
    """Run the prompt, build the cache. Returns (last_logits, caches).

    ``tokens: (B, S)``, this rank's rows; the logits are those of the last
    position (B, vocab_padded), under a model axis the rank's columns of
    the vocabulary. The attention layers' K/V and the MLA layers' c_kv and
    k_rope hold the prompt's S positions, grown to ``max_seq`` (default S)
    for the decode steps that follow, and under a model axis cut to this
    rank's block of them (split-KV); an SSM layer's cache serves any number
    of decode steps as it is. An encoder-decoder model runs its encoder
    over ``enc_in`` first; its layers' cross K/V hold the encoder output's
    projections for every decode step.

    Under context parallelism each rank runs its block of the prompt's
    positions (``seq_block``) and cuts its split-KV block from the K/V its
    layers gathered whole; the logits are the last position's, from the
    last model rank, over the whole vocabulary, alike on every rank."""
    check_explicit(rules)
    _check_context_parallel(cfg, rules)
    b, s = tokens.shape
    max_seq = max_seq or s
    lo, hi = seq_block(s, rules)
    tp = local_rules(rules)
    x = embed(_table(params, "tok", cfg, rules), tokens[:, lo:hi], tp, cfg.vocab_padded)
    enc_out = _enc_out(params, enc_in, cfg, rules)
    x, caches, _ = _backbone(params, x, cfg, _positions(b, hi - lo, tokens.device, lo), rules,
                             want_cache=True, enc_out=enc_out)
    if max_seq != s or rules.model_axis is not None:
        caches = _grow_caches(caches, cfg, max_seq, rules)
    x = x[:, -1:, :]
    if context_parallel(rules):  # the last position is the last model rank's
        x = gather_over_model(x, 1, rules)[:, -1:, :]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(_table(params, _unembed_name(params), cfg, rules), x, cfg.vocab, tp,
                   cfg.vocab_padded)[:, 0], caches


def decode_step(params, token, caches, pos, cfg: ArchConfig,
                rules: ShardingRules = NO_SHARDING):
    """One decode step. token: (B,) int; pos: (B,) int, the current length:
    the new token's position, where its K/V (MLA: c_kv and k_rope) are
    written (in place; under a model axis by the rank whose block holds
    it) and up to which it attends. An SSM layer carries its position in
    its state; an ``xattn`` layer attends over its cached cross K/V.

    Returns (logits (B, vocab_padded), new_caches); under a model axis the
    logits are the rank's columns (under context parallelism too: a decode
    step runs as under tensor parallelism, as in the reference)."""
    check_explicit(rules)
    rules = decode_rules(rules)
    x = embed(params["embed"], token[:, None], rules, cfg.vocab_padded)
    x, new_caches, _ = _backbone(params, x, cfg, pos[:, None], rules, caches=caches,
                                 cache_pos=pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab, rules, cfg.vocab_padded)[:, 0], new_caches

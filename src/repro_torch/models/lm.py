"""Model assembler of the port: every decoder-only family of the JAX
package — dense attention, sliding-window, MLA, MoE, SSM (Mamba2) and
hybrid (Zamba2).

Port of ``src/repro/models/lm.py`` for the layer kinds ``"attn"``,
``"attn_w"``, ``"attn_moe"``, ``"mla"``, ``"mla_moe"``, ``"ssm"`` and
``"hybrid_attn"``. Layers are organized into repeating *groups*, as in the
JAX package:

  dense (yi/granite/gemma-7b/chameleon):  group = [attn]
  gemma3:                                 group = [attn_w]*5 + [attn]
  llama4-scout:                           group = [attn_moe]
  deepseek-v2-lite:  prologue [mla],      group = [mla_moe]
  mamba2:                                 group = [ssm]
  zamba2:                                 group = [ssm]*6 + [hybrid_attn]

``hybrid_attn`` (Zamba2) is a *shared-weight* attention+MLP block: its
weights live once in ``params["shared"]``; each application has its own
2d->d input projection (``proj``) of the hidden state concatenated with the
embedding output. Leading dense layers (deepseek's first layer, a dense
MLA layer) are the *prologue*: ``params["prologue{i}"]`` and
``caches["prologue{i}"]``, run before the groups.

The JAX package scans over stacked group parameters; the port keeps the
groups' structure but not the stack: ``params["groups"]`` is a list with
one dict per group (``{"pos0": ..., "pos1": ...}``, one entry per layer of
the group), and ``_backbone`` is a Python loop over it, with no scan and no
rematerialization (the port has no compile whose size grows with depth, and
no training yet). ``_backbone`` sums the MoE layers' load-balancing aux and
returns it beside the caches; ``forward`` returns the logits only, and the
aux waits for ``train_loss`` (ROADMAP.md queue 1 item 4).

The kind "xattn" (whisper; ROADMAP.md queue 1 item 3) raises ``NotPorted``
at the entry points. The JAX package's ``rules`` (mesh sharding of
activations, params and caches: ``param_specs``, ``cache_specs``, MoE's
``shard_map`` branch) have no counterpart: the port runs on one card.

Entry points: ``init_params``, ``init_cache``, ``forward``, ``prefill``,
``decode_step``. They run where the parameters are (``init_params`` puts
them on the card unless asked for the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.paralingam import _device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    embed,
    init_dense,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    unembed,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

#: Layer kinds whose cache is K/V (B, S, KV, dh), or its int8 form.
ATTN_KINDS = ("attn", "attn_w", "attn_moe", "hybrid_attn")
#: Layer kinds whose cache is MLA's (c_kv (B, S, r), k_rope (B, S, dr)).
MLA_KINDS = ("mla", "mla_moe")
#: Layer kinds with an MoE FFN in place of the MLP.
MOE_KINDS = ("attn_moe", "mla_moe")
#: ROADMAP.md queue 1 item of each kind that is not ported yet.
_UNPORTED = {"xattn": "item 3: the encoder-decoder family"}


class NotPorted(NotImplementedError):
    """A layer kind or model family that the port does not have yet."""


def _not_ported(kind: str) -> NotPorted:
    return NotPorted(
        f"layer kind {kind!r} is not ported to PyTorch yet (ROADMAP.md queue 1 "
        f"{_UNPORTED[kind]}); the port serves the decoder-only families")


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


def _check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotPorted`` for a layer kind the port does not have."""
    for kind in group_layout(cfg):
        if kind in _UNPORTED:
            raise _not_ported(kind)


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
    else:
        params["attn"] = attn.init_attention(gen, cfg, dtype)
    params["ln2"] = init_rmsnorm(d, gen.device)
    if kind in MOE_KINDS:
        params["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        params["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype)
    return params


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    the target device (the card unless ``device="cpu"``), at the JAX
    package's scales. ``dtype`` defaults to ``cfg.dtype``."""
    _check_ported(cfg)
    dev = _device(device, "repro_torch.models.lm.init_params")
    dtype = dtype or _DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = group_layout(cfg)
    params = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype, cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, dev),
        "groups": [{f"pos{i}": _init_layer(gen, kind, cfg, dtype)
                    for i, kind in enumerate(layout)} for _ in range(cfg.n_groups)],
    }
    for i, kind in enumerate(prologue_layout(cfg)):
        params[f"prologue{i}"] = _init_layer(gen, kind, cfg, dtype)
    if cfg.family == "hybrid":
        params["shared"] = {"ln1": init_rmsnorm(cfg.d_model, dev),
                            "attn": attn.init_attention(gen, cfg, dtype),
                            "ln2": init_rmsnorm(cfg.d_model, dev),
                            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)}
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_layer(lp, kind, x, cfg, positions, *, shared=None, emb0=None, cache=None,
                 cache_pos=None, want_cache=True):
    """One layer. Returns (x, new_cache_entry, aux), aux the MoE layer's
    load-balancing loss (None for other kinds). ``cache_pos`` set means a
    decode step over ``cache``; otherwise the layer runs the sequence and
    returns the cache it builds (an attention layer builds none unless
    ``want_cache``)."""
    if kind == "ssm":
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cache_pos is not None:
            out, new_state = ssm_mod.mamba2_decode(lp["ssm"], h, cfg, cache)
        else:
            out, new_state = ssm_mod.mamba2_forward(lp["ssm"], h, cfg)
        return x + out, new_state, None

    if kind == "hybrid_attn":
        h = torch.cat([x, emb0], dim=-1) @ lp["proj"]
        h = rmsnorm(h, shared["ln1"], cfg.norm_eps)
        out, new_kv = attn.attention_block(shared["attn"], h, cfg, positions, window=0,
                                           kv_cache=cache, cache_pos=cache_pos,
                                           want_cache=want_cache)
        x = x + out
        h2 = rmsnorm(x, shared["ln2"], cfg.norm_eps)
        return x + mlp(shared["mlp"], h2, cfg.act), new_kv, None

    # attention (MLA or GQA) + (mlp | moe)
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if kind in MLA_KINDS:
        out, new_kv = attn.mla_block(lp["attn"], h, cfg, positions, kv_cache=cache,
                                     cache_pos=cache_pos, want_cache=want_cache)
    else:
        window = cfg.window if kind == "attn_w" else 0
        out, new_kv = attn.attention_block(lp["attn"], h, cfg, positions, window=window,
                                           kv_cache=cache, cache_pos=cache_pos,
                                           want_cache=want_cache)
    x = x + out
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if kind in MOE_KINDS:
        out2, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg)
        return x + out2, new_kv, aux
    return x + mlp(lp["mlp"], h2, cfg.act), new_kv, None


def _backbone(params, x, cfg, positions, *, caches=None, cache_pos=None, want_cache=False):
    """Run the prologue layers, then the groups' layers, in order. Returns
    (x, new_caches, aux): new_caches has one entry per layer
    (``"prologue{i}"`` and ``"groups"``, as ``init_cache``), aux the sum of
    the MoE layers' load-balancing losses (float32). With ``cache_pos`` it
    is a decode step over ``caches``; otherwise the sequence runs and its
    caches are built if ``want_cache`` (``prefill``), else new_caches is
    None (``forward``)."""
    layout = group_layout(cfg)
    emb0 = x if cfg.family == "hybrid" else None
    shared = params.get("shared")
    want_cache = want_cache or cache_pos is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {}
    for i, kind in enumerate(prologue_layout(cfg)):
        name = f"prologue{i}"
        x, new_caches[name], layer_aux = _apply_layer(
            params[name], kind, x, cfg, positions,
            cache=caches[name] if caches is not None else None, cache_pos=cache_pos,
            want_cache=want_cache)
        if layer_aux is not None:
            aux = aux + layer_aux
    new_groups = []
    for gi, gp in enumerate(params["groups"]):
        new_cache = {}
        for i, kind in enumerate(layout):
            c = caches["groups"][gi][f"pos{i}"] if caches is not None else None
            x, new_cache[f"pos{i}"], layer_aux = _apply_layer(
                gp[f"pos{i}"], kind, x, cfg, positions, shared=shared, emb0=emb0,
                cache=c, cache_pos=cache_pos, want_cache=want_cache)
            if layer_aux is not None:
                aux = aux + layer_aux
        new_groups.append(new_cache)
    new_caches["groups"] = new_groups
    return x, (new_caches if want_cache else None), aux


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None, :].expand(b, s)


# ---------------------------------------------------------------------------
# full forward pass
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg: ArchConfig, positions=None):
    """Full-sequence forward -> logits (B, S, vocab_padded)."""
    _check_ported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = embed(params["embed"], tokens)
    x, _, _ = _backbone(params, x, cfg, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int, dtype, device):
    if kind in MLA_KINDS:
        return (torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device),
                torch.zeros((batch, max_seq, cfg.rope_head_dim), dtype=dtype, device=device))
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
    (B, H, P, N) float32, conv tail (B, W-1, C)), with no sequence axis.
    The prologue's layers have theirs under ``"prologue{i}"``."""
    _check_ported(cfg)
    dev = _device(device, "repro_torch.models.lm.init_cache")
    dtype = dtype or _DTYPES[cfg.dtype]
    layout = group_layout(cfg)
    caches = {f"prologue{i}": _layer_cache(kind, cfg, batch, max_seq, dtype, dev)
              for i, kind in enumerate(prologue_layout(cfg))}
    caches["groups"] = [{f"pos{i}": _layer_cache(kind, cfg, batch, max_seq, dtype, dev)
                         for i, kind in enumerate(layout)} for _ in range(cfg.n_groups)]
    return caches


def _grow_caches(caches, cfg: ArchConfig, max_seq: int):
    """The caches with every attention layer's K/V (and int8 scales) and
    every MLA layer's c_kv and k_rope, the prologue's too, padded with zeros
    along the sequence axis (axis 1 of each) to ``max_seq``; an SSM layer's
    cache has no sequence axis and stays as it is. (The reference pads
    whichever axis has the prompt's length, which picks an SSM state axis
    of equal size, or an MLA cache's batch axis when B equals S.)"""
    layout = group_layout(cfg)

    def grow(kind, entry):
        if kind not in ATTN_KINDS + MLA_KINDS:
            return entry
        return tuple(F.pad(t, (0, 0) * (t.ndim - 2) + (0, max_seq - t.shape[1])) for t in entry)

    grown = {f"prologue{i}": grow(kind, caches[f"prologue{i}"])
             for i, kind in enumerate(prologue_layout(cfg))}
    grown["groups"] = [{f"pos{i}": grow(kind, g[f"pos{i}"]) for i, kind in enumerate(layout)}
                       for g in caches["groups"]]
    return grown


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def prefill(params, tokens, cfg: ArchConfig, max_seq: int | None = None):
    """Run the prompt, build the cache. Returns (last_logits, caches).

    ``tokens: (B, S)``; the logits are those of the last position (B,
    vocab_padded). The attention layers' K/V and the MLA layers' c_kv and
    k_rope hold the prompt's S positions, grown to ``max_seq`` (default S)
    for the decode steps that follow; an SSM layer's cache serves any
    number of decode steps as it is."""
    _check_ported(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    x, caches, _ = _backbone(params, x, cfg, _positions(b, s, tokens.device), want_cache=True)
    if max_seq is not None and max_seq != s:
        caches = _grow_caches(caches, cfg, max_seq)
    x = rmsnorm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], caches


def decode_step(params, token, caches, pos, cfg: ArchConfig):
    """One decode step. token: (B,) int; pos: (B,) int, the current length:
    the new token's position, where its K/V (MLA: c_kv and k_rope) are
    written (in place) and up to which it attends. An SSM layer carries its
    position in its state.

    Returns (logits (B, vocab_padded), new_caches)."""
    x = embed(params["embed"], token[:, None])
    x, new_caches, _ = _backbone(params, x, cfg, pos[:, None], caches=caches, cache_pos=pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], new_caches

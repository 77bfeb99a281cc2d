"""Model assembler of the port: the dense attention, sliding-window, SSM
(Mamba2) and hybrid (Zamba2) families.

Port of ``src/repro/models/lm.py`` for the layer kinds ``"attn"``,
``"attn_w"``, ``"ssm"`` and ``"hybrid_attn"``. Layers are organized into
repeating *groups*, as in the JAX package:

  dense (yi/granite/gemma-7b/chameleon):  group = [attn]
  gemma3:                                 group = [attn_w]*5 + [attn]
  mamba2:                                 group = [ssm]
  zamba2:                                 group = [ssm]*6 + [hybrid_attn]

``hybrid_attn`` (Zamba2) is a *shared-weight* attention+MLP block: its
weights live once in ``params["shared"]``; each application has its own
2d->d input projection (``proj``) of the hidden state concatenated with the
embedding output.

The JAX package scans over stacked group parameters; the port keeps the
groups' structure but not the stack: ``params["groups"]`` is a list with
one dict per group (``{"pos0": ..., "pos1": ...}``, one entry per layer of
the group), and ``_backbone`` is a Python loop over it, with no scan and no
rematerialization (the port has no compile whose size grows with depth, and
no training yet).

The kinds "mla", "mla_moe", "attn_moe" (deepseek-v2-lite, llama4-scout;
ROADMAP.md queue 1 item 2) and "xattn" (whisper; item 3), and leading dense
layers, raise ``NotPorted`` at the entry points. The JAX package's ``rules``
(mesh sharding of activations, params and caches: ``param_specs``,
``cache_specs``) have no counterpart: the port runs on one card.

Entry points: ``init_params``, ``init_cache``, ``forward``, ``prefill``,
``decode_step``. They run where the parameters are (``init_params`` puts
them on the card unless asked for the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.paralingam import _device
from repro_torch.models import attention as attn
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

#: Layer kinds whose cache is K/V with a sequence axis (axis 1 of each
#: tensor of the entry), grown to ``max_seq``.
ATTN_KINDS = ("attn", "attn_w", "hybrid_attn")
#: ROADMAP.md queue 1 item of each kind that is not ported yet.
_UNPORTED = {"mla": "item 2: MLA and MoE", "mla_moe": "item 2: MLA and MoE",
             "attn_moe": "item 2: MLA and MoE",
             "xattn": "item 3: the encoder-decoder family"}


class NotPorted(NotImplementedError):
    """A layer kind or model family that the port does not have yet."""


def _not_ported(kind: str) -> NotPorted:
    return NotPorted(
        f"layer kind {kind!r} is not ported to PyTorch yet (ROADMAP.md queue 1 "
        f"{_UNPORTED[kind]}); the port serves the dense attention, sliding-window, "
        "SSM and hybrid families")


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


def _check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotPorted`` for a layer kind the port does not have, and for
    leading dense layers (deepseek's prologue)."""
    for kind in group_layout(cfg):
        if kind in _UNPORTED:
            raise _not_ported(kind)
    if cfg.first_dense_layers:
        raise _not_ported("mla" if cfg.mla else "attn_moe")


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
    params["attn"] = attn.init_attention(gen, cfg, dtype)
    params["ln2"] = init_rmsnorm(d, gen.device)
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
    """One layer. Returns (x, new_cache_entry). ``cache_pos`` set means a
    decode step over ``cache``; otherwise the layer runs the sequence and
    returns the cache it builds (an attention layer builds none unless
    ``want_cache``)."""
    if kind == "ssm":
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cache_pos is not None:
            out, new_state = ssm_mod.mamba2_decode(lp["ssm"], h, cfg, cache)
        else:
            out, new_state = ssm_mod.mamba2_forward(lp["ssm"], h, cfg)
        return x + out, new_state

    if kind == "hybrid_attn":
        h = torch.cat([x, emb0], dim=-1) @ lp["proj"]
        h = rmsnorm(h, shared["ln1"], cfg.norm_eps)
        out, new_kv = attn.attention_block(shared["attn"], h, cfg, positions, window=0,
                                           kv_cache=cache, cache_pos=cache_pos,
                                           want_cache=want_cache)
        x = x + out
        h2 = rmsnorm(x, shared["ln2"], cfg.norm_eps)
        return x + mlp(shared["mlp"], h2, cfg.act), new_kv

    # "attn", "attn_w": attention + mlp
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    window = cfg.window if kind == "attn_w" else 0
    out, new_kv = attn.attention_block(lp["attn"], h, cfg, positions, window=window,
                                       kv_cache=cache, cache_pos=cache_pos,
                                       want_cache=want_cache)
    x = x + out
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg.act), new_kv


def _backbone(params, x, cfg, positions, *, caches=None, cache_pos=None, want_cache=False):
    """Run the layers in order. Returns (x, new_caches), one entry per layer
    in the groups' layout. With ``cache_pos`` it is a decode step over
    ``caches``; otherwise the sequence runs and its caches are built if
    ``want_cache`` (``prefill``), else new_caches is None (``forward``)."""
    layout = group_layout(cfg)
    emb0 = x if cfg.family == "hybrid" else None
    shared = params.get("shared")
    want_cache = want_cache or cache_pos is not None
    new_groups = []
    for gi, gp in enumerate(params["groups"]):
        new_cache = {}
        for i, kind in enumerate(layout):
            c = caches["groups"][gi][f"pos{i}"] if caches is not None else None
            x, new_cache[f"pos{i}"] = _apply_layer(
                gp[f"pos{i}"], kind, x, cfg, positions, shared=shared, emb0=emb0,
                cache=c, cache_pos=cache_pos, want_cache=want_cache)
        new_groups.append(new_cache)
    return x, ({"groups": new_groups} if want_cache else None)


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
    x, _ = _backbone(params, x, cfg, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int, dtype, device):
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
    scales); an SSM layer's is (state (B, H, P, N) float32, conv tail (B,
    W-1, C)), with no sequence axis."""
    _check_ported(cfg)
    dev = _device(device, "repro_torch.models.lm.init_cache")
    dtype = dtype or _DTYPES[cfg.dtype]
    layout = group_layout(cfg)
    return {"groups": [{f"pos{i}": _layer_cache(kind, cfg, batch, max_seq, dtype, dev)
                        for i, kind in enumerate(layout)} for _ in range(cfg.n_groups)]}


def _grow_caches(caches, cfg: ArchConfig, max_seq: int):
    """The caches with every attention layer's K/V (and int8 scales) padded
    with zeros along the sequence axis to ``max_seq``; an SSM layer's cache
    has no sequence axis and stays as it is. (The reference pads whichever
    axis has the prompt's length, which picks an SSM state axis of equal
    size.)"""
    layout = group_layout(cfg)

    def grow(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, max_seq - t.shape[1]))

    return {"groups": [{f"pos{i}": (tuple(grow(t) for t in g[f"pos{i}"])
                                    if kind in ATTN_KINDS else g[f"pos{i}"])
                        for i, kind in enumerate(layout)} for g in caches["groups"]]}


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def prefill(params, tokens, cfg: ArchConfig, max_seq: int | None = None):
    """Run the prompt, build the cache. Returns (last_logits, caches).

    ``tokens: (B, S)``; the logits are those of the last position (B,
    vocab_padded). The attention layers' K/V hold the prompt's S positions,
    grown to ``max_seq`` (default S) for the decode steps that follow; an
    SSM layer's cache serves any number of decode steps as it is."""
    _check_ported(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    x, caches = _backbone(params, x, cfg, _positions(b, s, tokens.device), want_cache=True)
    if max_seq is not None and max_seq != s:
        caches = _grow_caches(caches, cfg, max_seq)
    x = rmsnorm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], caches


def decode_step(params, token, caches, pos, cfg: ArchConfig):
    """One decode step. token: (B,) int; pos: (B,) int, the current length:
    the new token's position, where its K/V are written (in place) and up
    to which it attends. An SSM layer carries its position in its state.

    Returns (logits (B, vocab_padded), new_caches)."""
    x = embed(params["embed"], token[:, None])
    x, new_caches = _backbone(params, x, cfg, pos[:, None], caches=caches, cache_pos=pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], new_caches

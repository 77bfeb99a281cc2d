"""Model assembler of the port: the SSM (Mamba2) family.

Port of ``src/repro/models/lm.py`` for layer kind ``"ssm"``. The JAX
package organizes layers into repeating *groups* and scans over stacked
group parameters; the port keeps the groups' structure but not the stack:
``params["groups"]`` is a list with one dict per group (``{"pos0": layer
params}`` for Mamba2, whose group is one layer), and ``_backbone`` is a
Python loop over it, with no scan and no rematerialization (the port has no
compile whose size grows with depth, and no training yet).

Every other layer kind ("attn", "attn_w", "attn_moe", "mla", "mla_moe",
"hybrid_attn", "xattn") raises ``NotPorted`` at the entry points, naming
its ROADMAP item. The JAX package's ``rules`` (mesh sharding of activations, params and
caches: ``param_specs``, ``cache_specs``) have no counterpart: the port runs
on one card.

Entry points: ``init_params``, ``init_cache``, ``forward``, ``prefill``,
``decode_step``. They run where the parameters are (``init_params`` puts
them on the card unless asked for the CPU).
"""

from __future__ import annotations

import torch

from repro_torch.core.paralingam import _device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed, init_embedding, init_rmsnorm, rmsnorm, unembed

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class NotPorted(NotImplementedError):
    """A layer kind or model family that the port does not have yet."""


def _not_ported(kind: str) -> NotPorted:
    return NotPorted(
        f"layer kind {kind!r} is not ported to PyTorch yet (ROADMAP.md queue 1 "
        "item 10: the attention, MLA, MoE, hybrid and encoder-decoder families); "
        "the port serves the SSM family (mamba2-370m)")


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
    """Raise ``NotPorted`` unless every layer is an SSM layer: then each
    group is one layer, ``{"pos0": ...}``, as below."""
    for kind in group_layout(cfg):
        if kind != "ssm":
            raise _not_ported(kind)
    if cfg.first_dense_layers:
        raise _not_ported("mla" if cfg.mla else "attn")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: ArchConfig, dtype):
    # ssm blocks have no separate MLP
    return {"ln1": init_rmsnorm(cfg.d_model, gen.device),
            "ssm": ssm_mod.init_mamba2(gen, cfg, dtype)}


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    the target device (the card unless ``device="cpu"``), at the JAX
    package's scales. ``dtype`` defaults to ``cfg.dtype``."""
    _check_ported(cfg)
    dev = _device(device, "repro_torch.models.lm.init_params")
    dtype = dtype or _DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype, cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, dev),
        "groups": [{"pos0": _init_layer(gen, cfg, dtype)} for _ in range(cfg.n_groups)],
    }


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_layer(lp, x, cfg, *, cache=None):
    """One SSM layer. Returns (x, new_cache_entry)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cache is not None and x.shape[1] == 1:
        out, new_state = ssm_mod.mamba2_decode(lp["ssm"], h, cfg, cache)
    else:
        out, new_state = ssm_mod.mamba2_forward(lp["ssm"], h, cfg)
    return x + out, new_state


def _backbone(params, x, cfg, *, caches=None):
    """Run the layers in order. Returns (x, new_caches): the caches of every
    layer, or None when ``caches`` is None and none is wanted."""
    new_groups = []
    for gi, gp in enumerate(params["groups"]):
        c = caches["groups"][gi]["pos0"] if caches is not None else None
        x, nc = _apply_layer(gp["pos0"], x, cfg, cache=c)
        new_groups.append({"pos0": nc})
    return x, ({"groups": new_groups} if caches is not None else None)


# ---------------------------------------------------------------------------
# full forward pass
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg: ArchConfig):
    """Full-sequence forward -> logits (B, S, vocab_padded)."""
    _check_ported(cfg)
    x = embed(params["embed"], tokens)
    x, _ = _backbone(params, x, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, batch: int, dtype, device):
    c = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return (torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, c), dtype=dtype, device=device))


def init_cache(cfg: ArchConfig, batch: int, dtype=None, device=None):
    """Zero caches, one entry per layer. An SSM layer's is (state (B, H, P,
    N) float32, conv tail (B, W-1, C)): it has no sequence axis, so it takes
    no ``max_seq`` (the reference's sizes the attention kinds' K/V)."""
    _check_ported(cfg)
    dev = _device(device, "repro_torch.models.lm.init_cache")
    dtype = dtype or _DTYPES[cfg.dtype]
    return {"groups": [{"pos0": _layer_cache(cfg, batch, dtype, dev)}
                       for _ in range(cfg.n_groups)]}


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def prefill(params, tokens, cfg: ArchConfig):
    """Run the prompt, build the cache. Returns (last_logits, caches).

    ``tokens: (B, S)``; the logits are those of the last position (B,
    vocab_padded). An SSM layer's cache has no sequence axis: it serves any
    number of decode steps as it is."""
    _check_ported(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    fresh = init_cache(cfg, b, dtype=x.dtype, device=tokens.device)
    x, caches = _backbone(params, x, cfg, caches=fresh)
    x = rmsnorm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], caches


def decode_step(params, token, caches, pos, cfg: ArchConfig):
    """One decode step. token: (B,) int; pos: (B,) int, the current length
    (read by the attention kinds only; an SSM layer carries its position in
    its state).

    Returns (logits (B, vocab_padded), new_caches)."""
    del pos  # no positional input in an SSM layer
    x = embed(params["embed"], token[:, None])
    x, new_caches = _backbone(params, x, cfg, caches=caches)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], new_caches

"""Shared layers of the LM substrate: init, RMSNorm, RoPE, the gated MLP,
embedding, unembedding, the cross-entropy.

Port of ``src/repro/models/layers.py``. Parameters are plain nested dicts
of tensors, as in the JAX package (no ``nn.Module``), so
``models/convert.py`` carries its trees across leaf for leaf. Random init
draws from an explicit ``torch.Generator`` on the target device at the JAX
package's scales; the numbers differ from ``jax.random``'s, so tests carry
the JAX package's weights across instead.

``softmax_xent`` is the training loss's token cross-entropy.

Under a model axis (``rules.model_axis``, explicit tensor parallelism;
``dist.sharding``) each rank holds its shard of the weights as
``*_spec`` says: ``mlp`` is column-parallel (``wi_gate``, ``wi_up``) then
row-parallel (``wo``); ``embed`` is vocab-parallel on ``tok`` (its rows:
the ids outside this rank's rows read zero, then a sum over the model
ranks); ``unembed`` gives this rank's columns of the logits, through
``head`` or through ``tok``'s rows when the embeddings are tied; and
``softmax_xent`` is the vocab-parallel cross-entropy (the max, the sum of
exponentials and the target logit reduced over the model ranks). The
MLP's columns and the padded vocabulary are cut into balanced blocks
(``dist.sharding.Blocks``): uneven where the model ranks do not divide
them, so the vocabulary's functions take ``vocab_padded`` to place this
rank's block (``model_block``). Without a model axis every one is the
single-device function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (
    NO_SHARDING,
    Blocks,
    P,
    copy_to_model,
    max_over_model,
    model_block,
    reduce_from_model,
)


def init_dense(gen: torch.Generator, shape, in_axis_size: int, dtype):
    """Normal(0, 1 / in_axis_size) weights, drawn in float32 on the
    generator's device and cast to ``dtype``."""
    scale = 1.0 / math.sqrt(in_axis_size)
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def init_rmsnorm(d: int, device):
    return torch.zeros((d,), dtype=torch.float32, device=device)


#: The spec of a norm's scale (replicated).
NORM_SPEC = P(None)


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int -> (..., head_dim//2) float32 angles."""
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim
    )
    return positions[..., None].float() * freqs[None, :]


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, dh); positions: (B, S) or (S,). Rotates the split halves
    (x1, x2) = x[..., :dh/2], x[..., dh/2:], not interleaved pairs, in
    float32, and returns x's dtype."""
    dh = x.shape[-1]
    ang = rope_angles(positions, dh, theta)  # (B, S, dh/2) or (S, dh/2)
    if ang.ndim == 2:
        ang = ang[None, :, :]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {
        "wi_gate": init_dense(gen, (d_model, d_ff), d_model, dtype),
        "wi_up": init_dense(gen, (d_model, d_ff), d_model, dtype),
        "wo": init_dense(gen, (d_ff, d_model), d_ff, dtype),
    }


def mlp_spec(d_ff: int):
    cols = Blocks("model", d_ff)
    return {"wi_gate": P(None, cols), "wi_up": P(None, cols), "wo": P(cols, None)}


def mlp(params, x, act: str, rules=NO_SHARDING):
    """SwiGLU, or GeGLU with the tanh form of GELU (``jax.nn.gelu``'s
    default ``approximate=True``) when ``act == "geglu"``. Under a model
    axis ``params`` hold this rank's columns of ``wi_*`` and rows of
    ``wo``."""
    xr = copy_to_model(x, rules)
    gate = xr @ params["wi_gate"]
    up = xr @ params["wi_up"]
    if act == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.silu(gate) * up
    return reduce_from_model(h @ params["wo"], rules)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab_padded: int, d_model: int, dtype,
                   tie: bool):
    params = {"tok": (torch.randn((vocab_padded, d_model), generator=gen, device=gen.device)
                      * 0.02).to(dtype)}
    if not tie:
        params["head"] = init_dense(gen, (d_model, vocab_padded), d_model, dtype)
    return params


def embedding_spec(tie: bool, vocab_padded: int):
    rows = Blocks("model", vocab_padded)
    spec = {"tok": P(rows, None)}
    if not tie:
        spec["head"] = P(None, rows)
    return spec


def _vocab_start(n_local: int, vocab_padded: int | None, rules) -> int:
    """The first vocabulary row of this rank's ``n_local`` rows:
    ``model_block`` of ``vocab_padded`` (0 without a model axis)."""
    if rules.model_axis is None:
        return 0
    lo, hi = model_block(vocab_padded, rules)
    if hi - lo != n_local:
        raise ValueError(f"{n_local} vocabulary rows are not this rank's block of {vocab_padded}")
    return lo


def _vocab_rows(ids, n_local: int, vocab_padded: int | None, rules):
    """(ids within this rank's block of the vocabulary, as local indices
    clamped into it; the mask of the ids that lie in it)."""
    local = ids - _vocab_start(n_local, vocab_padded, rules)
    inside = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), inside


def embed(params, tokens, rules=NO_SHARDING, vocab_padded: int | None = None):
    """The token embeddings. Under a model axis ``tok`` holds this rank's
    rows of the vocabulary (its block of ``vocab_padded``): the ids
    outside them read zero, and the sum over the model ranks gives every
    row from the one rank that has it."""
    tok = params["tok"]
    if rules.model_axis is None:
        return tok[tokens]
    local, inside = _vocab_rows(tokens, tok.shape[0], vocab_padded, rules)
    rows = torch.where(inside[..., None], tok[local], 0)
    return reduce_from_model(rows, rules)


def unembed(params, x, vocab: int, rules=NO_SHARDING, vocab_padded: int | None = None):
    """Logits over the padded vocabulary, the padding masked to the float32
    minimum so that neither argmax nor a softmax ever picks it. Under a
    model axis, this rank's columns of them (``head``'s columns, or
    ``tok``'s rows when the embeddings are tied: its block of
    ``vocab_padded``), the padding masked by its global column."""
    xr = copy_to_model(x, rules)
    logits = xr @ params["head"] if "head" in params else xr @ params["tok"].T
    n_local = logits.shape[-1]
    start = _vocab_start(n_local, vocab_padded, rules)
    if (n_local if rules.model_axis is None else vocab_padded) != vocab:
        neg = torch.finfo(torch.float32).min
        cols = start + torch.arange(n_local, device=logits.device)
        logits = torch.where(cols >= vocab, neg, logits.float()).to(logits.dtype)
    return logits


def softmax_xent(logits, labels, vocab: int, rules=NO_SHARDING, vocab_padded: int | None = None):
    """Mean token cross-entropy; logits upcast to float32; labels < vocab
    (the padded columns hold the float32 minimum and add nothing). The
    log-sum-exp is ``torch.logsumexp``'s (the max, then the log of the sum
    of the shifted exponentials, plus the max). Under a model axis
    ``logits`` are this rank's columns: the max, the sum of the
    exponentials and the target logit are reduced over the model ranks."""
    logits = logits.float()
    top = max_over_model(logits.detach().amax(dim=-1), rules)
    sumexp = reduce_from_model(torch.exp(logits - top[..., None]).sum(dim=-1), rules)
    lse = top + torch.log(sumexp)
    local, inside = _vocab_rows(labels.long(), logits.shape[-1], vocab_padded, rules)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, gold, 0.0), rules)
    return torch.mean(lse - gold)

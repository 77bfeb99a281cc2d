"""Shared layers of the LM substrate: init, RMSNorm, RoPE, the gated MLP,
embedding, unembedding, the cross-entropy.

Port of ``src/repro/models/layers.py``. Parameters are plain nested dicts
of tensors, as in the JAX package (no ``nn.Module``), so
``models/convert.py`` carries its trees across leaf for leaf. Random init
draws from an explicit ``torch.Generator`` on the target device at the JAX
package's scales; the numbers differ from ``jax.random``'s, so tests carry
the JAX package's weights across instead.

``softmax_xent`` is the training loss's token cross-entropy. The JAX
package's sharding specs and ``rules.act`` constraints have no
counterpart: the port runs on one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_dense(gen: torch.Generator, shape, in_axis_size: int, dtype):
    """Normal(0, 1 / in_axis_size) weights, drawn in float32 on the
    generator's device and cast to ``dtype``."""
    scale = 1.0 / math.sqrt(in_axis_size)
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def init_rmsnorm(d: int, device):
    return torch.zeros((d,), dtype=torch.float32, device=device)


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


def mlp(params, x, act: str):
    """SwiGLU, or GeGLU with the tanh form of GELU (``jax.nn.gelu``'s
    default ``approximate=True``) when ``act == "geglu"``."""
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    if act == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.silu(gate) * up
    return h @ params["wo"]


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


def embed(params, tokens):
    return params["tok"][tokens]


def unembed(params, x, vocab: int):
    """Logits over the padded vocabulary, the padding masked to the float32
    minimum so that neither argmax nor a softmax ever picks it."""
    logits = x @ params["head"] if "head" in params else x @ params["tok"].T
    v_pad = logits.shape[-1]
    if v_pad != vocab:
        neg = torch.finfo(torch.float32).min
        pad_mask = torch.arange(v_pad, device=logits.device) >= vocab
        logits = torch.where(pad_mask, neg, logits.float()).to(logits.dtype)
    return logits


def softmax_xent(logits, labels, vocab: int):
    """Mean token cross-entropy; logits upcast to float32; labels < vocab
    (the padded columns hold the float32 minimum and add nothing)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)

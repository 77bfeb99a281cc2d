"""Shared layers of the LM substrate: init, RMSNorm, embedding, unembedding.

Port of ``src/repro/models/layers.py`` for the SSM family. Parameters are
plain nested dicts of tensors, as in the JAX package (no ``nn.Module``), so
``models/convert.py`` carries its trees across leaf for leaf. Random init
draws from an explicit ``torch.Generator`` on the target device at the
JAX package's scales; the numbers differ from ``jax.random``'s, so tests
carry the JAX package's weights across instead.

RoPE, the gated MLP and ``softmax_xent`` come with the attention and
training slices (ROADMAP.md queue 1 item 10). The JAX package's sharding
specs and ``rules.act`` constraints have no counterpart: the port runs on
one card.
"""

from __future__ import annotations

import math

import torch


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

"""Attention: GQA/MQA, causal, blocked, sliding-window (banded) and
split-KV decode, with an optional int8 KV cache, and MLA (DeepSeek-V2's
compressed KV cache with an absorbed decode).

Port of ``src/repro/models/attention.py``. All variants but MLA share the
convention q: (B, S, H, dh), k/v: (B, S, KV, dh), with H = KV * q_per_kv.
Scores come from an einsum in the compute dtype, cast to float32; the
softmax runs in float32 and the probabilities are cast to v's dtype.
Masked scores are ``NEG_INF = -2**30``, not -inf, so a fully masked row
gives a uniform row, not NaN.

There is no TPU kernel behind any of these: the reference computes them
with jnp ops, and so does the port, with torch ops (no
``scaled_dot_product_attention``). The reference's blocked scan is a Python
loop over the q chunks; its sharding constraints have no counterpart on one
card (``pick_q_chunk`` runs with one batch shard).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, init_dense, init_rmsnorm, rmsnorm

NEG_INF = -2.0**30


def init_attention(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    params = {
        "wq": init_dense(gen, (d, cfg.q_dim), d, dtype),
        "wk": init_dense(gen, (d, cfg.kv_dim), d, dtype),
        "wv": init_dense(gen, (d, cfg.kv_dim), d, dtype),
        "wo": init_dense(gen, (cfg.q_dim, d), cfg.q_dim, dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = init_rmsnorm(cfg.head_dim, gen.device)
        params["k_norm"] = init_rmsnorm(cfg.head_dim, gen.device)
    return params


def _split_heads(x, n, dh):
    b, s, _ = x.shape
    return x.reshape(b, s, n, dh)


def qkv(params, x, cfg, positions):
    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k):
    """(B,S,H,dh) x (B,T,KV,dh) -> (B, KV, qpk, S, T) f32 scores."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    return scores / math.sqrt(dh)


def _gqa_out(probs, v, h):
    b, kv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, v.shape[-1])


def causal_attention(q, k, v, q_positions, kv_positions, window: int = 0):
    """Full (or windowed, via masking) causal attention. Materializes the
    (S, T) score matrix — use blocked_attention for long sequences.
    Positions are (B, S) and (B, T)."""
    scores = _gqa_scores(q, k)  # (B,KV,g,S,T)
    mask = kv_positions[:, None, :] <= q_positions[:, :, None]  # (B,S,T)
    if window > 0:
        mask &= kv_positions[:, None, :] > q_positions[:, :, None] - window
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v, q.shape[2])


def pick_q_chunk(b: int, h: int, s: int, batch_shards: int = 1,
                 budget_bytes: int = 1 << 30) -> int:
    """Largest power-of-two q-chunk whose f32 score buffer fits the budget
    (per device: b/batch_shards x h x chunk x s x 4 bytes)."""
    b_loc = max(1, b // max(batch_shards, 1))
    chunk = 512
    while chunk > 64 and b_loc * h * chunk * s * 4 > budget_bytes:
        chunk //= 2
    return chunk


def blocked_attention(q, k, v, q_positions, kv_positions, window: int = 0,
                      q_chunk: int = 256):
    """Memory-bounded attention: a loop over q chunks.

    * full causal: each q chunk scores against the whole KV (masked);
      live f32 buffer = (B, H, q_chunk, S) instead of (B, H, S, S).
    * windowed (q_chunk == window): chunk ci scores against the 2W keys
      starting at max(ci*W - W, 0) — O(S*W) FLOPs, exact (mask from
      positions). Chunk 0 therefore sees chunk 1's keys, which the mask
      hides, as in the reference.
    """
    s = q.shape[1]
    if window > 0:
        q_chunk = window
    if s % q_chunk != 0 or s <= q_chunk:
        return causal_attention(q, k, v, q_positions, kv_positions, window)
    outs = []
    for ci in range(s // q_chunk):
        rows = slice(ci * q_chunk, (ci + 1) * q_chunk)
        if window > 0:
            start = max(ci * window - window, 0)
            keys = slice(start, start + 2 * window)
            outs.append(causal_attention(q[:, rows], k[:, keys], v[:, keys],
                                         q_positions[:, rows], kv_positions[:, keys],
                                         window=window))
        else:
            outs.append(causal_attention(q[:, rows], k, v, q_positions[:, rows],
                                         kv_positions))
    # output head dim follows v
    return torch.cat(outs, dim=1)


def banded_attention(q, k, v, positions, window: int):
    """Sliding-window attention with O(S*W) FLOPs: chunk the sequence into
    window-size chunks; chunk c attends to chunks (c-1, c) with the causal +
    window mask. Exact for window <= chunk size."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    w = window
    if s % w != 0:
        raise ValueError("sequence must be divisible by the window for banded attention")
    nc = s // w
    qc = q.reshape(b, nc, w, h, dh)
    kc = k.reshape(b, nc, w, kv, dh)
    vc = v.reshape(b, nc, w, kv, dh)
    pad_k = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    pad_v = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([pad_k, kc], dim=2)  # (b, nc, 2w, kv, dh)
    v2 = torch.cat([pad_v, vc], dim=2)
    qg = qc.reshape(b, nc, w, kv, h // kv, dh)
    scores = torch.einsum("bcskgd,bctkd->bckgst", qg, k2).float()
    scores = scores / math.sqrt(dh)
    pos_q = positions.reshape(b, nc, w)
    pos_k = torch.cat([pos_q - w, pos_q], dim=-1)  # previous chunk positions then own
    valid = ((pos_k[:, :, None, :] <= pos_q[:, :, :, None])
             & (pos_k[:, :, None, :] > pos_q[:, :, :, None] - w)
             & (pos_k[:, :, None, :] >= 0))
    scores = torch.where(valid[:, :, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgst,bctkd->bcskgd", probs.to(v.dtype), v2)
    return out.reshape(b, s, h, dh)


def decode_attention(q, k_cache, v_cache, pos, window: int = 0):
    """One-token decode: q (B, 1, H, dh) against a (B, S, KV, dh) cache,
    valid positions < pos (per-batch)."""
    b, _, h, dh = q.shape
    kv = k_cache.shape[2]
    s = k_cache.shape[1]
    qg = q.reshape(b, kv, h // kv, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float()
    scores = scores / math.sqrt(dh)
    t = torch.arange(s, device=q.device)[None, :]
    valid = t < pos[:, None]
    if window > 0:
        valid &= t >= pos[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh)


def attention_block(params, x, cfg, positions, *, window: int, kv_cache=None,
                    cache_pos=None, want_cache=True):
    """Full attention block: qkv -> (cached) attention -> output projection.

    With ``cache_pos`` ((B,) int, the position of the one new token) this is
    a decode step: the token's K/V are written into ``kv_cache`` *in place*
    (the caches are the step's to consume, as the reference's donated
    buffers) and attention reads the cache up to and including it.
    Otherwise (prefill, forward) it attends over the sequence itself.
    Returns (out, new_kv): the cache written, else the fresh (k, v), or
    their int8 form (values and bf16 scales) when ``cfg.kv_quant ==
    "int8"``, or None when ``want_cache`` is False (``forward``)."""
    q, k, v = qkv(params, x, cfg, positions)
    if cache_pos is not None:
        if cfg.kv_quant == "int8":
            kq, ks, vq, vs = kv_cache
            _cache_write_q(kq, ks, k, cache_pos)
            _cache_write_q(vq, vs, v, cache_pos)
            k_deq = dequantize_kv(kq, ks, k.dtype)
            v_deq = dequantize_kv(vq, vs, v.dtype)
            out = decode_attention(q, k_deq, v_deq, cache_pos + 1, window)
            new_kv = (kq, ks, vq, vs)
        else:
            k_cache, v_cache = kv_cache
            _cache_write(k_cache, k, cache_pos)
            _cache_write(v_cache, v, cache_pos)
            out = decode_attention(q, k_cache, v_cache, cache_pos + 1, window)
            new_kv = (k_cache, v_cache)
    else:
        q_chunk = pick_q_chunk(x.shape[0], cfg.n_heads, x.shape[1])
        out = blocked_attention(q, k, v, positions, positions, window, q_chunk)
        if not want_cache:
            new_kv = None
        elif cfg.kv_quant == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            new_kv = (kq, ks, vq, vs)
        else:
            new_kv = (k, v)
    out = out.reshape(*x.shape[:2], cfg.q_dim)
    return out @ params["wo"], new_kv


def _cache_write(cache, new, pos):
    """Write one token (B, 1, KV, dh) into (B, S, KV, dh) at per-batch pos,
    in place (an indexed write: O(new) bytes, not a pass over the cache)."""
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), pos] = new[:, 0].to(cache.dtype)


# ---------------------------------------------------------------------------
# int8 KV cache: per-(token, head) absmax scales
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """(B, S, KV, dh) float -> (int8 values, (B, S, KV) bf16 scales).
    Rounds half to even (``torch.round``, as ``jnp.round``)."""
    amax = torch.amax(torch.abs(x.float()), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale.float()[..., None]).to(dtype)


def _cache_write_q(cache_q, cache_scale, new, pos):
    """Quantize one token and write it into the int8 cache, in place."""
    b = cache_q.shape[0]
    q, s = quantize_kv(new)
    rows = torch.arange(b, device=cache_q.device)
    cache_q[rows, pos] = q[:, 0]
    cache_scale[rows, pos] = s[:, 0]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache, absorbed decode
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    r = cfg.kv_lora_rank
    dn, dr, dh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.head_dim
    h = cfg.n_heads
    return {
        "wq": init_dense(gen, (d, h * (dn + dr)), d, dtype),
        "w_dkv": init_dense(gen, (d, r + dr), d, dtype),
        "w_uk": init_dense(gen, (r, h * dn), r, dtype),
        "w_uv": init_dense(gen, (r, h * dh), r, dtype),
        "wo": init_dense(gen, (h * dh, d), h * dh, dtype),
        "kv_norm": init_rmsnorm(r, gen.device),
    }


def mla_block(params, x, cfg, positions, *, kv_cache=None, cache_pos=None, want_cache=True):
    """MLA attention. Cache = (c_kv (B, S, r) after ``kv_norm``, k_rope
    (B, S, dr) after RoPE); ``cfg.kv_quant`` does not apply to it.

    With ``cache_pos`` ((B,) int) this is a decode step in the absorbed
    form: the token's entry is written into the cache *in place*, the
    scores are q_nope @ W_uk[h] against the compressed cache plus q_rope ·
    k_rope over positions ``<= cache_pos``, and the output is re-projected
    with W_uv; the cache stays r + dr wide. Otherwise (prefill, forward)
    the materialized form: K_nope and V decompressed through W_uk and W_uv,
    k_rope broadcast over the heads, then ``blocked_attention`` (v's head
    dim, ``head_dim``, differs from q's and k's, nope + rope). Returns
    (out, cache), the cache None when not ``want_cache``. The reference
    takes the decode form when S == 1, which routes a one-token prompt
    wrongly; the port takes it when ``cache_pos`` is given, as elsewhere."""
    b, s, _ = x.shape
    h, dn, dr, dh, r = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.head_dim,
                        cfg.kv_lora_rank)
    q = (x @ params["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ params["w_dkv"]  # (B, S, r + dr)
    c_kv, k_rope = dkv[..., :r], dkv[..., r:]
    c_kv = rmsnorm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache_pos is not None:
        c_cache, kr_cache = kv_cache
        rows = torch.arange(b, device=x.device)
        c_cache[rows, cache_pos] = c_kv[:, 0].to(c_cache.dtype)
        kr_cache[rows, cache_pos] = k_rope[:, 0].to(kr_cache.dtype)
        # absorbed scores: q_eff (B, H, r) = q_nope @ W_uk[h]
        q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], params["w_uk"].reshape(r, h, dn))
        scores = (torch.einsum("bhr,btr->bht", q_eff, c_cache)
                  + torch.einsum("bhd,btd->bht", q_rope[:, 0], kr_cache)).float()
        scores = scores / math.sqrt(dn + dr)
        pos_t = torch.arange(c_cache.shape[1], device=x.device)[None, :]
        valid = pos_t <= cache_pos[:, None]
        scores = torch.where(valid[:, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        attn_c = torch.einsum("bht,btr->bhr", probs.to(c_cache.dtype), c_cache)
        out = torch.einsum("bhr,rhd->bhd", attn_c, params["w_uv"].reshape(r, h, dh))[:, None]
        new_cache = (c_cache, kr_cache)
    else:
        k_nope = (c_kv @ params["w_uk"]).reshape(b, s, h, dn)
        v = (c_kv @ params["w_uv"]).reshape(b, s, h, dh)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = blocked_attention(q_full, k_full, v, positions, positions,
                                q_chunk=pick_q_chunk(b, h, s))
        new_cache = (c_kv, k_rope) if want_cache else None
    return out.reshape(b, s, h * dh) @ params["wo"], new_cache

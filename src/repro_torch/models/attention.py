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
loop over the q chunks.

Under a model axis (``rules.model_axis``; ``dist.sharding``) the training
forward is tensor-parallel, with the weights as ``attention_spec`` and
``mla_spec`` shard them: each rank runs its block of the q heads (``wq``'s
columns) and ``wo``'s matching rows, and the model ranks' outputs are
summed. The blocks are ``head_block``'s: balanced, the first ``H % M``
ranks one head more, empty past H where ``H < M`` (the even cut where M
divides H; ``dist.sharding.Blocks`` cuts the leaves at those head
boundaries). ``wk`` and ``wv`` are sharded only when ``n_kv_heads % 16
== 0``, as in the reference; otherwise every rank projects all KV heads
and keeps those its q heads read under GQA. A rank's block may cut across
GQA groups (yi-34b's rank 1 of 16 holds q heads 4-7 of groups 7 wide):
``kv_runs`` splits it into runs that each read their KV heads alike, the
attention runs once per run on its slice of q and of the KV heads
(``by_runs``, no K/V repeated per q head), and the runs' outputs are
concatenated. MLA's ``w_uk`` and ``w_uv`` are column-parallel and
``w_dkv`` and ``kv_norm`` replicated.

Serving under a model axis keeps the caches split-KV, as ``lm.cache_specs``
lays them out: every KV head, the sequence over ``model`` (rank r holds
positions ``dist.sharding.seq_slice``). The prefill attends with the rank's
q heads as ``forward`` does and returns every KV head's K/V of the whole
sequence (all-gathered over heads where ``wk``/``wv`` shard), which
``lm.prefill`` cuts to the rank's positions. A decode step:

1. computes the new token's K/V of every KV head (MLA: ``c_kv`` and
   ``k_rope``, alike on every rank), and the rank that owns position
   ``pos`` (per row) writes them in place;
2. all-gathers q over ``model`` (MLA: the absorbed q and q_rope), the
   blocks padded to the largest and trimmed where they are uneven;
3. each rank computes every head's partial softmax over its own positions:
   the running max, the sum of exponentials and the weighted V (MLA: the
   weighted ``c_kv``), in float32;
4. all-gathers the partials, and combines them for the rank's own heads in
   rank order;
5. then ``wo``'s rows (MLA: ``w_uv``, then ``wo``'s rows) and the sum over
   ``model``, as in ``forward``.

Serving runs outside autograd: these collectives have no backward.

Under context parallelism (``dist.sharding.context_parallel``: the
reference's ``cp_seq``, training and prefill) ``x`` is this rank's block
of S/M positions and ``params`` hold the whole weights (``lm`` gathers
them where the layer runs): q holds the block's positions with every head,
and K and V (MLA: ``c_kv`` and ``k_rope``) are all-gathered along the
sequence over ``model`` (``gather_seq``, whose backward reduce-scatters
their gradients). The masks read global positions: ``blocked_attention``
takes the q block's first position and sizes its q chunks by the whole
sequence's keys that each chunk scores, and rank r's causal rows find their
keys among the first (r+1)·S/M of the S it scores, the reference's layout
(not rebalanced). The output projection needs no sum over ``model``. A
prefill returns the gathered K/V of the whole sequence, which
``lm.prefill`` cuts to the rank's split-KV block.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import (
    NO_SHARDING,
    Blocks,
    P,
    context_parallel,
    copy_to_model,
    gather_over_model,
    gather_seq,
    local_rules,
    model_block,
    model_index,
    reduce_from_model,
    seq_block,
)
from repro_torch.models.layers import NORM_SPEC, apply_rope, init_dense, init_rmsnorm, rmsnorm

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


def kv_sharded(cfg) -> bool:
    """Whether ``wk`` and ``wv`` shard over ``model`` (the reference's rule,
    ``attention.py:37-38``: only when ``n_kv_heads % 16 == 0``)."""
    return cfg.n_kv_heads % 16 == 0


def attention_spec(cfg):
    heads, kv_heads = (Blocks("model", n, cfg.head_dim) for n in (cfg.n_heads, cfg.n_kv_heads))
    kv = P(None, kv_heads) if kv_sharded(cfg) else P(None, None)
    spec = {"wq": P(None, heads), "wk": kv, "wv": kv, "wo": P(heads, None)}
    if cfg.qk_norm:
        spec["q_norm"] = NORM_SPEC
        spec["k_norm"] = NORM_SPEC
    return spec


def head_block(n_heads: int, rules=NO_SHARDING) -> tuple[int, int]:
    """This rank's block ``(lo, hi)`` of ``n_heads`` heads (all of them
    without a model axis): ``dist.sharding.model_block``, balanced, the
    first ``n_heads % M`` ranks one head more, empty where ``n_heads < M``
    and this rank is past them."""
    return model_block(n_heads, rules)


def head_blocks(cfg, rules=NO_SHARDING):
    """This rank's q heads ``(lo, hi)`` and the KV heads ``(lo, hi)`` they
    read under GQA (none for an empty block). Where ``wk`` and ``wv``
    shard, the rank's KV shard must be those KV heads: the model ranks
    split the KV heads evenly, or each KV head serves one q head."""
    q_lo, q_hi = head_block(cfg.n_heads, rules)
    g = cfg.n_heads // cfg.n_kv_heads
    kv = (q_lo // g, -(-q_hi // g) if q_hi > q_lo else q_lo // g)
    sharded = rules.model_axis is not None and kv_sharded(cfg)
    if sharded and kv != head_block(cfg.n_kv_heads, rules):
        raise ValueError(f"{cfg.n_kv_heads} sharded KV heads do not split over "
                         f"{rules.model_size} model ranks as their {cfg.n_heads} q heads do")
    return (q_lo, q_hi), kv


def kv_runs(cfg, rules=NO_SHARDING) -> list[tuple[int, int, int, int]]:
    """This rank's q heads cut into runs that read their KV heads alike:
    ``(q_start, q_stop, kv_start, kv_stop)`` offsets into the rank's q
    heads and into the KV heads they read (``head_blocks``), each run the
    longest stretch of KV heads from which the rank holds the same number
    of q heads. One run where the block covers whole groups or lies within
    one (every block under an even split), up to three where it cuts
    across groups; none for an empty block."""
    (q_lo, q_hi), (kv_lo, kv_hi) = head_blocks(cfg, rules)
    g = cfg.n_heads // cfg.n_kv_heads
    runs: list = []
    q = 0
    for j in range(kv_hi - kv_lo):
        kv = kv_lo + j
        n = min(q_hi, (kv + 1) * g) - max(q_lo, kv * g)
        if runs and runs[-1][1] - runs[-1][0] == n * (runs[-1][3] - runs[-1][2]):
            runs[-1] = (runs[-1][0], q + n, runs[-1][2], j + 1)
        else:
            runs.append((q, q + n, j, j + 1))
        q += n
    return runs


def by_runs(fn, q, k, v, runs, *args, **kwargs):
    """``fn`` (a GQA attention of this module, ``fn(q, k, v, ...)``) over
    the rank's q heads and the KV heads they read, run by run
    (``kv_runs``): each run's slice of q against its slice of k and v,
    the outputs concatenated over the heads; ``fn`` itself on the whole
    for one run or none."""
    if len(runs) <= 1:
        return fn(q, k, v, *args, **kwargs)
    return torch.cat([fn(q[:, :, qa:qb], k[:, :, ka:kb], v[:, :, ka:kb], *args, **kwargs)
                      for qa, qb, ka, kb in runs], dim=2)


def _split_heads(x, n, dh):
    b, s, _ = x.shape
    return x.reshape(b, s, n, dh)


def qkv(params, x, cfg, positions, rules=NO_SHARDING, all_kv=False):
    """q, k, v after the optional qk norms and RoPE. Under a model axis,
    this rank's q heads and the KV heads they read; with ``all_kv`` (the
    caches, outside autograd) k and v hold every KV head instead."""
    (q_lo, q_hi), (kv_lo, kv_hi) = head_blocks(cfg, rules)
    xr = copy_to_model(x, rules)
    dh = cfg.head_dim
    q = _split_heads(xr @ params["wq"], q_hi - q_lo, dh)
    whole_kv = rules.model_axis is None or not kv_sharded(cfg)
    if whole_kv:  # every KV head, computed alike on every model rank
        k = _split_heads(x @ params["wk"], cfg.n_kv_heads, dh)
        v = _split_heads(x @ params["wv"], cfg.n_kv_heads, dh)
    else:
        k = _split_heads(xr @ params["wk"], kv_hi - kv_lo, dh)
        v = _split_heads(xr @ params["wv"], kv_hi - kv_lo, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, copy_to_model(params["q_norm"], rules), cfg.norm_eps)
        k_norm = params["k_norm"] if whole_kv else copy_to_model(params["k_norm"], rules)
        k = rmsnorm(k, k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if rules.model_axis is None:
        return q, k, v
    if all_kv:
        if not whole_kv:
            k = gather_over_model(k, 2, rules, cfg.n_kv_heads)
            v = gather_over_model(v, 2, rules, cfg.n_kv_heads)
        return q, k, v
    if whole_kv:
        k = copy_to_model(k, rules)[:, :, kv_lo:kv_hi]
        v = copy_to_model(v, rules)[:, :, kv_lo:kv_hi]
    return q, k, v


def rank_kv(k, v, cfg, rules):
    """The KV heads this rank's q heads read, of every head's k and v."""
    if rules.model_axis is None:
        return k, v
    _, (kv_lo, kv_hi) = head_blocks(cfg, rules)
    return k[:, :, kv_lo:kv_hi], v[:, :, kv_lo:kv_hi]


def _gqa_scores(q, k):
    """(B,S,H,dh) x (B,T,KV,dh) -> (B, KV, qpk, S, T) f32 scores."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // max(kv, 1), dh)  # an empty block: no heads, no KV heads
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
                      q_chunk: int = 256, q_start: int = 0):
    """Memory-bounded attention: a loop over q chunks.

    * full causal: each q chunk scores against the whole KV (masked);
      live f32 buffer = (B, H, q_chunk, S) instead of (B, H, S, S).
    * windowed (q_chunk == window): chunk ci scores against the 2W keys
      starting at max(ci*W - W, 0) — O(S*W) FLOPs, exact (mask from
      positions). Chunk 0 therefore sees chunk 1's keys, which the mask
      hides, as in the reference.

    ``q_start`` is the index in k and v of q's first position (a context-
    parallel rank's block of a sequence whose K/V it holds whole); the
    windowed chunks' keys start ``q_start`` further on. The fallback to
    ``causal_attention`` goes by q's own length.
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
            start = max(q_start + ci * window - window, 0)
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
    qg = qc.reshape(b, nc, w, kv, h // max(kv, 1), dh)
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
    qg = q.reshape(b, kv, h // max(kv, 1), dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float()
    scores = scores / math.sqrt(dh)
    valid = _valid_from(0, s, pos, window, q.device)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh)


def _valid_from(start: int, length: int, pos, window: int, device):
    """(B, length) mask of the cache positions ``start .. start + length -
    1`` that a token at ``pos - 1`` attends to: ``t < pos`` and, with a
    window, ``t >= pos - window`` (absolute positions)."""
    t = start + torch.arange(length, device=device)[None, :]
    valid = t < pos[:, None]
    if window > 0:
        valid &= t >= pos[:, None] - window
    return valid


def _partials(scores):
    """Masked float32 scores (..., T) -> (running max (...), sum of
    exponentials (...), the exponentials (..., T))."""
    top = scores.amax(dim=-1)
    e = torch.exp(scores - top[..., None])
    return top, e.sum(dim=-1), e


def combine_partials(top, total, weighted, rules):
    """Every head's partial softmax over this rank's positions, ``top`` and
    ``total`` (B, H), ``weighted`` (B, H, D) float32, all-gathered over
    ``model`` and combined for this rank's heads (``head_block``) in rank
    order: (B, h, D) float32, the softmax-weighted sum over every
    position."""
    lo, hi = head_block(top.shape[1], rules)
    packed = torch.cat([top[..., None], total[..., None], weighted], dim=-1)
    parts = gather_over_model(packed[None], 0, rules)[:, :, lo:hi]  # (M, B, h, D + 2)
    peak = parts[..., 0].amax(dim=0)
    scale = torch.exp(parts[..., 0] - peak)  # (M, B, h)
    total = scale[0] * parts[0, ..., 1]
    out = scale[0][..., None] * parts[0, ..., 2:]
    for r in range(1, parts.shape[0]):
        total = total + scale[r] * parts[r, ..., 1]
        out = out + scale[r][..., None] * parts[r, ..., 2:]
    return out / total[..., None]


def split_decode_attention(q, k_cache, v_cache, pos, start, rules, window: int = 0, *,
                           n_heads: int):
    """``decode_attention`` over a split-KV cache: this rank's block of the
    ``n_heads`` q heads (B, 1, h, dh) against every KV head of its
    positions ``start ..`` of the cache (B, L, KV, dh); valid positions <
    pos (per row, absolute). Returns this rank's heads' (B, 1, h, dh)."""
    b, _, _, dh = q.shape
    kv, length = k_cache.shape[2], k_cache.shape[1]
    q_all = gather_over_model(q, 2, rules, n_heads)[:, 0]  # (B, H, dh)
    h = q_all.shape[1]
    qg = q_all.reshape(b, kv, h // kv, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float() / math.sqrt(dh)
    valid = _valid_from(start, length, pos, window, q.device)
    top, total, e = _partials(torch.where(valid[:, None, None, :], scores, NEG_INF))
    weighted = torch.einsum("bkgt,btkd->bkgd", e, v_cache.float())
    out = combine_partials(top.reshape(b, h), total.reshape(b, h), weighted.reshape(b, h, dh),
                           rules)
    return out.to(v_cache.dtype)[:, None]


def attention_block(params, x, cfg, positions, rules=NO_SHARDING, *, window: int,
                    kv_cache=None, cache_pos=None, want_cache=True):
    """Full attention block: qkv -> (cached) attention -> output projection.

    With ``cache_pos`` ((B,) int, the position of the one new token) this is
    a decode step: the token's K/V are written into ``kv_cache`` *in place*
    (the caches are the step's to consume, as the reference's donated
    buffers) and attention reads the cache up to and including it.
    Otherwise (prefill, forward) it attends over the sequence itself.
    Returns (out, new_kv): the cache written, else the fresh (k, v), or
    their int8 form (values and bf16 scales) when ``cfg.kv_quant ==
    "int8"``, or None when ``want_cache`` is False (``forward``). Under a
    model axis the output is the sum over the model ranks of their heads'
    part, the fresh K/V hold every KV head, and a decode step reads this
    rank's block of a split-KV cache (the module's docstring). Under
    context parallelism (not at a decode step) q holds this rank's
    positions with every head, and the fresh K/V the whole sequence's,
    gathered along it."""
    cp = context_parallel(rules) and cache_pos is None
    seq_rules, rules = rules, (local_rules(rules) if cp else rules)
    split = rules.model_axis is not None and (cache_pos is not None or want_cache)
    q, k, v = qkv(params, x, cfg, positions, rules, all_kv=split)
    if cache_pos is not None:
        if cfg.kv_quant == "int8":
            kq, ks, vq, vs = kv_cache
            start = _cache_write_q(kq, ks, k, cache_pos, rules)
            _cache_write_q(vq, vs, v, cache_pos, rules)
            k_now, v_now = dequantize_kv(kq, ks, k.dtype), dequantize_kv(vq, vs, v.dtype)
            new_kv = (kq, ks, vq, vs)
        else:
            k_now, v_now = kv_cache
            start = _cache_write(k_now, k, cache_pos, rules)
            _cache_write(v_now, v, cache_pos, rules)
            new_kv = (k_now, v_now)
        if split:
            out = split_decode_attention(q, k_now, v_now, cache_pos + 1, start, rules, window,
                                         n_heads=cfg.n_heads)
        else:
            out = decode_attention(q, k_now, v_now, cache_pos + 1, window)
    else:
        k, v = gather_seq(k, 1, seq_rules), gather_seq(v, 1, seq_rules)
        k_att, v_att = rank_kv(k, v, cfg, rules) if split else (k, v)
        kv_positions, q_start = seq_keys(positions, k.shape[1], seq_rules)
        q_chunk = pick_q_chunk(x.shape[0], q.shape[2], k.shape[1])
        out = by_runs(blocked_attention, q, k_att, v_att, kv_runs(cfg, rules), positions,
                      kv_positions, window, q_chunk, q_start=q_start)
        if not want_cache:
            new_kv = None
        elif cfg.kv_quant == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            new_kv = (kq, ks, vq, vs)
        else:
            new_kv = (k, v)
    out = out.reshape(*x.shape[:2], q.shape[2] * cfg.head_dim)
    return reduce_from_model(out @ params["wo"], rules), new_kv


def seq_keys(positions, t: int, rules):
    """(the (B, t) positions of the keys that q at ``positions`` scores,
    the index among them of q's first position). Under context parallelism
    the keys are the whole sequence's ``0 .. t - 1``, gathered along it,
    and q is this rank's block (``seq_block``); otherwise they are q's own
    positions."""
    if not context_parallel(rules):
        return positions, 0
    b = positions.shape[0]
    return torch.arange(t, device=positions.device)[None, :].expand(b, t), seq_block(t, rules)[0]


def _owner_rows(cache, pos, rules):
    """(rows, this rank's local index of each row's ``pos`` clamped into
    its block, whether this rank owns it, the block's start) for a write
    into a (B, L, ...) cache; without a model axis the rank owns all."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    if rules.model_axis is None:
        return rows, pos, None, 0
    start, length = model_index(rules) * cache.shape[1], cache.shape[1]
    local = pos - start
    mine = (local >= 0) & (local < length)
    return rows, local.clamp(0, length - 1), mine, start


def _write(cache, rows, index, mine, new):
    """``cache[rows, index] = new`` where ``mine`` (everywhere when None):
    an indexed write of one token per row, in place, with no host sync."""
    if mine is not None:
        shape = (-1,) + (1,) * (new.ndim - 1)
        new = torch.where(mine.reshape(shape), new, cache[rows, index])
    cache[rows, index] = new


def _cache_write(cache, new, pos, rules=NO_SHARDING):
    """Write one token (B, 1, KV, dh) into (B, S, KV, dh) at per-batch pos,
    in place (an indexed write: O(new) bytes, not a pass over the cache).
    Under a model axis the cache is this rank's block of a split-KV cache
    and only the rank that owns ``pos`` writes. Returns the block's first
    position."""
    rows, index, mine, start = _owner_rows(cache, pos, rules)
    _write(cache, rows, index, mine, new[:, 0].to(cache.dtype))
    return start


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


def _cache_write_q(cache_q, cache_scale, new, pos, rules=NO_SHARDING):
    """Quantize one token and write it into the int8 cache, in place (the
    owner rank only, under a model axis). Returns the block's first
    position."""
    q, s = quantize_kv(new)
    rows, index, mine, start = _owner_rows(cache_q, pos, rules)
    _write(cache_q, rows, index, mine, q[:, 0])
    _write(cache_scale, rows, index, mine, s[:, 0])
    return start


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


def mla_spec(cfg):
    h = cfg.n_heads
    return {"wq": P(None, Blocks("model", h, cfg.nope_head_dim + cfg.rope_head_dim)),
            "w_dkv": P(None, None), "w_uk": P(None, Blocks("model", h, cfg.nope_head_dim)),
            "w_uv": P(None, Blocks("model", h, cfg.head_dim)),
            "wo": P(Blocks("model", h, cfg.head_dim), None), "kv_norm": NORM_SPEC}


def mla_block(params, x, cfg, positions, rules=NO_SHARDING, *, kv_cache=None, cache_pos=None,
              want_cache=True):
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
    wrongly; the port takes it when ``cache_pos`` is given, as elsewhere.
    Under a model axis this rank's heads: ``c_kv`` and ``k_rope`` are
    computed alike on every model rank and enter the heads' region; a
    decode step reads this rank's block of a split-KV cache, the absorbed
    q and q_rope all-gathered and the partials combined for the rank's
    heads before ``W_uv`` (the module's docstring). Under context
    parallelism every head of this rank's positions, ``c_kv`` and
    ``k_rope`` gathered along the sequence before their decompression, and
    the cache the whole sequence's latent."""
    b, s, _ = x.shape
    dn, dr, dh, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.head_dim, cfg.kv_lora_rank
    cp = context_parallel(rules) and cache_pos is None
    seq_rules, rules = rules, (local_rules(rules) if cp else rules)
    q_lo, q_hi = head_block(cfg.n_heads, rules)
    h = q_hi - q_lo
    q = (copy_to_model(x, rules) @ params["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ params["w_dkv"]  # (B, S, r + dr)
    c_kv, k_rope = dkv[..., :r], dkv[..., r:]
    c_kv = rmsnorm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache_pos is not None:
        c_cache, kr_cache = kv_cache
        rows, index, mine, start = _owner_rows(c_cache, cache_pos, rules)
        _write(c_cache, rows, index, mine, c_kv[:, 0].to(c_cache.dtype))
        _write(kr_cache, rows, index, mine, k_rope[:, 0].to(kr_cache.dtype))
        # absorbed scores: q_eff (B, H, r) = q_nope @ W_uk[h]
        q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], params["w_uk"].reshape(r, h, dn))
        q_r = q_rope[:, 0]
        if rules.model_axis is not None:
            q_eff = gather_over_model(q_eff, 1, rules, cfg.n_heads)
            q_r = gather_over_model(q_r, 1, rules, cfg.n_heads)
        scores = (torch.einsum("bhr,btr->bht", q_eff, c_cache)
                  + torch.einsum("bhd,btd->bht", q_r, kr_cache)).float()
        scores = scores / math.sqrt(dn + dr)
        valid = _valid_from(start, c_cache.shape[1], cache_pos + 1, 0, x.device)
        scores = torch.where(valid[:, None, :], scores, NEG_INF)
        if rules.model_axis is None:
            probs = torch.softmax(scores, dim=-1)
            attn_c = torch.einsum("bht,btr->bhr", probs.to(c_cache.dtype), c_cache)
        else:
            top, total, e = _partials(scores)
            attn_c = combine_partials(top, total, torch.einsum("bht,btr->bhr", e, c_cache.float()),
                                      rules).to(c_cache.dtype)
        out = torch.einsum("bhr,rhd->bhd", attn_c, params["w_uv"].reshape(r, h, dh))[:, None]
        new_cache = (c_cache, kr_cache)
    else:
        # under context parallelism the latent of the whole sequence
        c_kv, k_rope = gather_seq(c_kv, 1, seq_rules), gather_seq(k_rope, 1, seq_rules)
        t = c_kv.shape[1]
        kv_positions, q_start = seq_keys(positions, t, seq_rules)
        c_in = copy_to_model(c_kv, rules)
        k_nope = (c_in @ params["w_uk"]).reshape(b, t, h, dn)
        v = (c_in @ params["w_uv"]).reshape(b, t, h, dh)
        k_r = copy_to_model(k_rope, rules)
        k_full = torch.cat([k_nope, k_r[:, :, None, :].expand(b, t, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = blocked_attention(q_full, k_full, v, positions, kv_positions,
                                q_chunk=pick_q_chunk(b, h, t), q_start=q_start)
        new_cache = (c_kv, k_rope) if want_cache else None
    return reduce_from_model(out.reshape(b, s, h * dh) @ params["wo"], rules), new_cache

"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) blocks.

Port of ``src/repro/models/ssm.py``. Chunked SSD: the sequence is split into
chunks of ``cfg.ssm_chunk``; within a chunk the output is the dual quadratic
(attention-like) form; across chunks a loop over the chunks carries the
(H, P, N) state (the JAX package's ``lax.scan``). That is the prefill, torch
ops and ``torch.einsum``, with no kernel in either package. Decode is the
O(1) recurrent step with a rolling depthwise-conv state; its state update is
the hand-written ``ssd_decode`` kernel (``kernels.ops.ssd_decode``), which
on a CPU tensor runs its plain version.

Parameters are a plain dict per layer, as in the JAX package. Matrix
products run in the parameters' type; on the card a float32 product is
full float32 only at the "highest" matmul precision (PyTorch's default,
and what ``chip_smoke.py`` sets). ``ngroups == 1`` is assumed, as there.

``mamba2_spec`` gives the reference's sharding specs of a layer's weights.
Under a model axis (``rules.model_axis``; ``dist.sharding``) each rank runs
its block of the H heads, H/M of them (``ssm_head_block``: the model
ranks must divide H, which the attention's balanced blocks do not need),
and the inner channels that belong to them:

* ``w_zx`` holds the rank's columns of z and of x (a split leaf:
  ``dist.sharding.SPLIT_PARTS``); ``w_dt``, ``dt_bias``, ``a_log``,
  ``d_skip``, the gated norm's scale and ``w_out``'s rows are the rank's
  heads';
* the (g=1, N) B and C stay whole: ``w_bc`` is replicated, and its output
  enters the heads' region through ``copy_to_model``, as do the replicated
  ``conv_w`` and ``conv_b`` before the rank takes its channels of them
  (x's of its heads, then all of B's and C's), so that their gradients
  are summed over ``model``;
* the gated RMSNorm's mean is over all of ``d_inner``: the rank's sum of
  squares is summed over ``model`` forward and backward;
* ``w_out``'s rows give a partial output, summed over ``model``
  (``reduce_from_model``);
* the chunked SSD and the decode kernel run on the rank's H/M heads.

The rank's decode state is its heads' (B, H/M, P, N) SSM state, as
``cache_specs`` cuts it, and a conv tail of its own channels, (B, W-1,
d_inner/M + 2N): x's channels of its heads, then the whole B and C. That
is not ``local_shard`` of the one-rank tail under its spec ``P(b, None,
m)``, which would cut the (x | B | C) channels evenly;
``models.lm.local_caches`` and ``gather_caches`` map between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import NO_SHARDING, P, copy_to_model, model_block, reduce_from_model
from repro_torch.kernels import ops
from repro_torch.models.layers import init_dense


def init_mamba2(gen: torch.Generator, cfg, dtype):
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, w = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
    assert g == 1, "ngroups > 1 not supported"
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_zx": init_dense(gen, (d, 2 * di), d, dtype),
        "w_bc": init_dense(gen, (d, 2 * g * n), d, dtype),
        "w_dt": init_dense(gen, (d, h), d, dtype),
        "conv_w": (torch.randn((w, di + 2 * g * n), generator=gen, device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((di + 2 * g * n,), dtype=dtype, device=dev),
        "a_log": torch.zeros((h,), **f32),  # A = -exp(a_log) = -1
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": torch.zeros((di,), **f32),
        "w_out": init_dense(gen, (di, d), di, dtype),
    }


def mamba2_spec():
    return {"w_zx": P(None, "model"), "w_bc": P(None, None), "w_dt": P(None, "model"),
            "conv_w": P(None, None), "conv_b": P(None), "a_log": P("model"),
            "d_skip": P("model"), "dt_bias": P("model"), "norm": P("model"),
            "w_out": P("model", None)}


def _softplus(v):
    """log(1 + e^v) as ``jax.nn.softplus`` takes it: max(v, 0) +
    log1p(e^-|v|)."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-torch.abs(v)))


def _gated_rmsnorm(y, z, scale, eps, rules=NO_SHARDING, width=None):
    """The gated RMSNorm over the last axis. Under a model axis ``y`` and
    ``z`` are the rank's channels and the mean is over all ``width`` of
    them: the rank's sum of squares summed over ``model`` forward and
    backward (``reduce_from_model``, then ``copy_to_model``)."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    if rules.model_axis is None:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    else:
        ss = torch.sum(torch.square(yf), dim=-1, keepdim=True)
        var = copy_to_model(reduce_from_model(ss, rules), rules) / width
    return (yf * torch.rsqrt(var + eps) * (1.0 + scale)).to(y.dtype)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    return out + b[None, None, :]


def _segsum(dta):
    """(B, C, H, Q) log-decays -> (B, C, H, Q, Q) lower-triangular
    L[i, j] = sum_{k=j+1..i} dta[k] (and -inf above the diagonal)."""
    q = dta.shape[-1]
    cs = torch.cumsum(dta, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dta.device))
    return torch.where(mask, diff, -torch.inf)


def ssm_head_block(cfg, rules=NO_SHARDING) -> tuple[int, int]:
    """This rank's block ``(lo, hi)`` of the SSM's heads, an even one:
    raises where the model ranks do not divide them (``mamba2_spec``'s
    plain ``model`` entries cut the heads' leaves evenly)."""
    h, m = cfg.n_ssm_heads, rules.model_size
    if h % m:
        raise ValueError(f"{h} SSM heads do not split over {m} model ranks")
    return model_block(h, rules)


def _rank_channels(t, cfg, rules):
    """The rank's conv channels of a (..., d_inner + 2N) tensor: x's
    channels of its heads, then the whole B and C (all of it without a
    model axis)."""
    if rules.model_axis is None:
        return t
    lo, hi = ssm_head_block(cfg, rules)
    p = cfg.ssm_headdim
    return torch.cat([t[..., lo * p:hi * p], t[..., cfg.d_inner:]], dim=-1)


def _projections(params, x, cfg, rules=NO_SHARDING):
    """z and x of the rank's heads, the conv input ``x | B | C`` (B and C
    whole, entered into the region) and dt of the rank's heads."""
    xr = copy_to_model(x, rules)
    zx = xr @ params["w_zx"]
    z, xin = torch.chunk(zx, 2, dim=-1)
    bc = copy_to_model(x @ params["w_bc"], rules)
    dt = _softplus((xr @ params["w_dt"]).float() + params["dt_bias"])
    return z, torch.cat([xin, bc], dim=-1), dt


def _conv_params(params, cfg, rules):
    """``conv_w`` and ``conv_b`` at the rank's channels, entered into the
    heads' region."""
    return (_rank_channels(copy_to_model(params["conv_w"], rules), cfg, rules),
            _rank_channels(copy_to_model(params["conv_b"], rules), cfg, rules))


def _split_conv(conv_out, cfg, di):
    """(x of ``di`` channels, B, C) of a conv output."""
    n = cfg.ssm_state
    return conv_out[..., :di], conv_out[..., di:di + n], conv_out[..., di + n:]


def _reduce_out(params, y, z, cfg, rules):
    """The gated norm, then ``w_out``'s rows, summed over ``model``."""
    y = _gated_rmsnorm(y, z, params["norm"], cfg.norm_eps, rules, cfg.d_inner)
    return reduce_from_model(y @ params["w_out"], rules)


def mamba2_forward(params, x, cfg, rules=NO_SHARDING, initial_state=None):
    """Chunked SSD over a full sequence. x: (B, S, D).

    Returns (out, (ssm_state, conv_tail)), the final states for the decode
    handoff (under a model axis the rank's heads and channels)."""
    b, s_true, _ = x.shape
    n, p = cfg.ssm_state, cfg.ssm_headdim
    h_lo, h_hi = ssm_head_block(cfg, rules)
    h = h_hi - h_lo
    di = h * p
    q = min(cfg.ssm_chunk, s_true)
    # Pad the sequence to a chunk multiple; padded positions get dt = 0 so
    # they neither update the state (dt*B*x = 0) nor decay it (exp(0*A) = 1).
    s = (s_true + q - 1) // q * q
    if s != s_true:
        x = F.pad(x, (0, 0, 0, s - s_true))
    nc = s // q

    z, conv_in, dt = _projections(params, x, cfg, rules)  # dt: (B, S, H)
    if s != s_true:
        valid = (torch.arange(s, device=x.device) < s_true)[None, :, None]
        dt = dt * valid
    conv_out = F.silu(_causal_conv(conv_in, *_conv_params(params, cfg, rules)))
    xin, b_in, c_in = _split_conv(conv_out, cfg, di)

    xc = xin.reshape(b, nc, q, h, p)
    bc_ = b_in.reshape(b, nc, q, n)
    cc_ = c_in.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    a = -torch.exp(params["a_log"])  # (H,)
    dtac = dtc * a[None, None, None, :]  # (B, nc, Q, H) log-decay

    dta_h = torch.movedim(dtac, -1, -2)  # (B, nc, H, Q)
    decay = torch.exp(_segsum(dta_h))  # (B, nc, H, Q, Q)

    # intra-chunk dual quadratic form
    cb = torch.einsum("bcin,bcjn->bcij", cc_, bc_)  # (B, nc, Q, Q)
    dtj = torch.movedim(dtc, -1, -2)  # (B, nc, H, Q)
    scores = cb[:, :, None, :, :] * decay * dtj[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores.float(), xc.float())

    # chunk-boundary states
    cum = torch.cumsum(dtac, dim=2)  # (B, nc, Q, H)
    rem = torch.exp(cum[:, :, -1:, :] - cum)  # decay j -> chunk end
    wx = xc.float() * (dtc * rem)[..., None]  # (B, nc, Q, H, P)
    s_chunk = torch.einsum("bcjn,bcjhp->bchpn", bc_.float(), wx)

    # inter-chunk recurrence (the reference's lax.scan)
    chunk_decay = torch.exp(torch.sum(dtac, dim=2))  # (B, nc, H)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for k in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, k, :, None, None] + s_chunk[:, k]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    in_decay = torch.exp(cum)  # (B, nc, Q, H)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc_.float(), prev_states)
    y_inter = y_inter * in_decay[..., None]

    y = y_intra + y_inter
    y = y + xc.float() * params["d_skip"][None, None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    if s != s_true:
        y = y[:, :s_true]
        z = z[:, :s_true]
    out = _reduce_out(params, y, z, cfg, rules)

    # The last W-1 conv inputs; a prompt shorter than that is left-padded
    # with the zeros the causal conv assumed (the reference's negative slice
    # start takes too few rows there).
    tail = cfg.ssm_conv - 1
    conv_tail = F.pad(conv_in[:, max(s_true - tail, 0):s_true, :],
                      (0, 0, max(tail - s_true, 0), 0))
    return out, (state, conv_tail)


def mamba2_decode(params, x, cfg, rules, state):
    """One-token recurrent step. x: (B, 1, D); state = (ssm, conv_tail),
    under a model axis the rank's.

    The state update is one launch of the ``ssd_decode`` kernel on the card
    (its plain version on the CPU), on the rank's heads; the new state is a
    fresh tensor."""
    b = x.shape[0]
    p = cfg.ssm_headdim
    h_lo, h_hi = ssm_head_block(cfg, rules)
    h = h_hi - h_lo
    ssm_state, conv_tail = state  # (B, H, P, N), (B, W-1, C)

    z, conv_in, dt = _projections(params, x, cfg, rules)
    dt = dt[:, 0]  # (B, H)
    window = torch.cat([conv_tail, conv_in], dim=1)  # (B, W, C)
    conv_w, conv_b = _conv_params(params, cfg, rules)
    conv_out = F.silu(torch.sum(window * conv_w[None], dim=1) + conv_b[None])  # (B, C)
    xin, b_t, c_t = _split_conv(conv_out, cfg, h * p)
    xh = xin.reshape(b, h, p).float()

    a = -torch.exp(params["a_log"])
    y, ssm_state = ops.ssd_decode(ssm_state, xh, dt, b_t, c_t, a, params["d_skip"])
    y = y.reshape(b, 1, h * p).to(x.dtype)
    return _reduce_out(params, y, z, cfg, rules), (ssm_state, window[:, 1:, :])

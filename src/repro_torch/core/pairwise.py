"""Vectorized pairwise residual-entropy scores — the ParaLiNGAM hot-spot.

For normalized rows ``xn: (p, n)`` with correlation matrix ``c: (p, p)``, the
residual of regressing ``x_i`` on ``x_j`` renormalized via paper Eq. (10) is

    u_ij = (x_i - c_ij * x_j) / sqrt(1 - c_ij^2)

The matrix ``HR[i, j] = H_hat(u_ij)`` holds every residual entropy *exactly
once*; the paper's messaging mechanism (Section 3.1) corresponds to forming

    I[i, j] = (Hx[j] - Hx[i]) + (HR[i, j] - HR[j, i])        (antisymmetric)
    S[i]    = sum_j  min(0, I[i, j])^2                        (masked)

so each unordered pair contributes to *both* workers' scores from one
computation. These functions are the plain torch formulations; the CUDA
kernel in ``repro_torch.kernels.fused_score`` computes the fused triangular
sweep by hand.

Every (rows, cols, n) residual intermediate is built in chunks of at most
``CHUNK_ELEMS`` float32 elements' bytes (half as many float64 elements),
batched over many tiles or columns at once, so a p=512 sweep is a handful of
large tensor ops rather than a loop per tile.
Masked rows may hold non-finite data: every mask is applied with a select
(``torch.where``), never a multiply.

The sample-shard seam of the messaging ring (``dist/ring_order.py``): with
``group`` set, the rows hold only this rank's equal shard of the n samples,
and the raw moment sums are summed across the ranks of that
``torch.distributed`` group (one ``all_reduce``) before the one divide by
the whole count and the nonlinear entropy epilogue. Without a group nothing
changes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.covariance import VAR_EPS, _sample_count, per_dataset
from repro_torch.core.entropy import entropy_from_moments, log_cosh, u_exp_moment

#: Budget of one chunk's (tiles, b, b, n) or (p, cols, n) residual tensor,
#: in float32 elements (64 MB); ``_chunk_elems`` turns it into elements of
#: the data's dtype, so a float64 chunk holds half as many.
CHUNK_ELEMS = 1 << 24


def _chunk_elems(t) -> int:
    """Elements of ``t``'s dtype that fit one chunk's bytes."""
    return max(1, CHUNK_ELEMS * 4 // t.element_size())


def _sum_across(m1_sum, m2_sum, group):
    """The raw moment sums summed over the sample shards of ``group`` (one
    ``all_reduce`` of both); unchanged without a group."""
    if group is None:
        return m1_sum, m2_sum
    both = torch.stack([m1_sum, m2_sum])
    dist.all_reduce(both, group=group)
    return both[0], both[1]


def _whole_count(n_valid, n: int, group):
    """The denominator of the moments of rows holding ``n`` samples: the
    valid count of zero-padded data, else ``n`` times the sample shards of
    ``group`` (``covariance._sample_count`` of the whole sample axis)."""
    return _sample_count(n_valid, n if group is None else n * dist.get_world_size(group))


def residual_entropy_block(xn, c_cols, xj, n_valid=None, backend: str = "torch", *,
                           live_i=None, live_j=None, group=None):
    """HR block for all rows of ``xn: (..., p, n)`` against ``xj: (..., bj, n)``
    with correlations ``c_cols: (..., p, bj)``. Returns (..., p, bj).

    ``backend`` ``"hopper"``/``"hopper_fused"`` takes the raw moment sums of
    one dataset (``xn: (p, n)``) from the square moments kernel
    (``kernels.ops.pairwise_moments``) and runs the same finalize: the kernel
    emits sums, so ``n_valid`` changes only the denominator. The kernel sums
    only the pairs of live rows (``live_i: (p,)``, ``live_j: (bj,)`` bool,
    None: all) over the first ``n_valid`` samples; entries of a pair with a
    dead row are then the entropy of zero sums, which no score reads (the
    plain path computes every pair). ``group`` is the sample-shard seam (see
    the module docstring); the kernel then sums every local sample."""
    if backend in ("hopper", "hopper_fused"):
        from repro_torch.kernels import ops as kops

        m1_sum, m2_sum = kops.pairwise_moments(
            xn.contiguous(), xj.contiguous(), c_cols.contiguous(), live_i=live_i,
            live_j=live_j, n_valid=n_valid if group is None else None)
        return finalize_moments(m1_sum, m2_sum, _whole_count(n_valid, xj.shape[-1], group),
                                group=group)
    denom = torch.sqrt(torch.clamp(1.0 - torch.square(c_cols), min=VAR_EPS))
    u = (xn[..., :, None, :] - c_cols[..., None] * xj[..., None, :, :]) / denom[..., None]
    return stream_entropy(u, n_valid=n_valid, group=group)


def stream_moments(u, n_valid=None, group=None):
    """The two Hyvarinen moments of each length-n residual stream: per-stream
    means of ``log cosh u`` and ``u exp(-u^2/2)`` (reduce axis -1), taken as
    raw sums over the sample axis divided by the valid count. Zero-padded
    sample columns add exactly 0 to both sums, so ``n_valid`` only changes
    the denominator. A (B,) ``n_valid`` holds one count per entry of the
    leading axis of ``u``. ``group``: the sums of every sample shard."""
    den = per_dataset(_whole_count(n_valid, u.shape[-1], group), u.ndim - 1)
    m1, m2 = _sum_across(torch.sum(log_cosh(u), dim=-1), torch.sum(u_exp_moment(u), dim=-1),
                         group)
    return m1 / den, m2 / den


def finalize_moments(m1_sum, m2_sum, den, group=None):
    """Entropy epilogue over raw moment *sums*: sum them across the sample
    shards of ``group`` (if any), divide by the valid count ``den`` of the
    whole sample axis, then apply the nonlinear Hyvarinen formula."""
    m1_sum, m2_sum = _sum_across(m1_sum, m2_sum, group)
    return entropy_from_moments(m1_sum / den, m2_sum / den)


def stream_entropy(u, n_valid=None, group=None):
    """Hyvarinen entropy of each length-n residual stream (reduce axis -1)."""
    m1, m2 = stream_moments(u, n_valid=n_valid, group=group)
    return entropy_from_moments(m1, m2)


def residual_entropy_block_pair(xi, c_blk, xj, n_valid=None):
    """Both-direction residual entropies for (batches of) block pairs.

    ``xi: (..., bi, n)``, ``xj: (..., bj, n)``, ``c_blk: (..., bi, bj)``.
    Returns ``(hr_fwd, hr_rev)`` with ``hr_fwd[a, b] = H(r_{x_a}^{(x_b)})``
    and ``hr_rev[a, b] = H(r_{x_b}^{(x_a)})`` — one load of each block feeds
    both directions."""
    inv = torch.rsqrt(torch.clamp(1.0 - torch.square(c_blk), min=VAR_EPS))[..., None]
    xi4 = xi[..., :, None, :]
    xj4 = xj[..., None, :, :]
    u_f = (xi4 - c_blk[..., None] * xj4) * inv
    u_r = (xj4 - c_blk[..., None] * xi4) * inv
    return stream_entropy(u_f, n_valid=n_valid), stream_entropy(u_r, n_valid=n_valid)


def pair_moments(xn, c_vals, xj, n_valid=None, group=None):
    """Both-direction residual entropies of *gathered* comparison chunks.

    The threshold scheduler's per-round evaluation: worker rows ``xn:
    (..., m, n)`` against their gathered chunk targets ``xj: (..., m, k, n)``
    with correlations ``c_vals: (..., m, k)``. Returns ``(hr_fwd, hr_rev)``,
    each (..., m, k), with ``hr_fwd[w, b] = H(r_{x_w}^{(x_jb)})``; both
    directions come from one load of each stream (the messaging reuse).
    ``n_valid`` is None, one count, or one per dataset of the leading axis;
    ``group`` the sample-shard seam of the ring's threshold machine."""
    inv = torch.rsqrt(torch.clamp(1.0 - torch.square(c_vals), min=VAR_EPS))[..., None]
    xi = xn[..., :, None, :]
    cv = c_vals[..., None]
    u_f = (xi - cv * xj) * inv
    u_r = (xj - cv * xi) * inv
    return (stream_entropy(u_f, n_valid=n_valid, group=group),
            stream_entropy(u_r, n_valid=n_valid, group=group))


def _credits(stat, pm):
    """Masked messaging credits min(0, I)^2 (forward) and min(0, -I)^2."""
    fwd = torch.where(pm, torch.square(torch.clamp(stat, max=0.0)), 0.0)
    rev = torch.where(pm, torch.square(torch.clamp(-stat, max=0.0)), 0.0)
    return fwd, rev


def diag_block_scores(xb, c_diag, hxb, mb, n_valid=None):
    """Messaging-folded score contributions of the *diagonal* block tiles.

    ``xb: (nt, b, n)`` row blocks, ``c_diag: (nt, b, b)`` the matching
    diagonal correlation blocks, ``hxb: (nt, b)`` row entropies, ``mb:
    (nt, b)`` live mask, ``n_valid`` one count or one per tile (nt,). One HR
    block per tile covers both orderings of every in-block pair, so only the
    row-sum credit applies. Returns (nt, b)."""
    nt, b, n = xb.shape
    eye = torch.eye(b, dtype=torch.bool, device=xb.device)
    step = max(1, _chunk_elems(xb) // max(b * b * n, 1))
    per_tile = isinstance(n_valid, torch.Tensor) and n_valid.ndim == 1
    out = []
    for t0 in range(0, nt, step):
        sl = slice(t0, t0 + step)
        hr = residual_entropy_block(xb[sl], c_diag[sl], xb[sl],
                                    n_valid=n_valid[sl] if per_tile else n_valid)
        stat = pair_stat_matrix(hxb[sl], hr)
        pm = mb[sl, :, None] & mb[sl, None, :] & ~eye
        out.append(torch.sum(_credits(stat, pm)[0], dim=-1))
    return torch.cat(out)


def tri_block_maps(nt: int):
    """Static (numpy) tile maps of the strictly-lower triangular block grid:
    every unordered off-diagonal block pair (i < j) exactly once, in
    row-major order (the order of ``torch.triu_indices(nt, nt, 1)``)."""
    pairs = [(i, j) for i in range(nt) for j in range(i + 1, nt)]
    imap = np.asarray([ij[0] for ij in pairs], np.int32)
    jmap = np.asarray([ij[1] for ij in pairs], np.int32)
    return imap, jmap


def fused_layout(xn, c, mask, block: int, n_valid=None):
    """Shared prologue of the fused triangular sweep (plain path and kernel
    wrapper): pad p to the tile size, reshape into (nt, b) tiles and score
    the diagonal tiles. Returns ``(xpad, cp, c4, hxb, mb, s_diag)`` with
    ``xpad: (nt*b, n)``, ``cp: (nt*b, nt*b)`` the padded correlations,
    ``c4: (nt, nt, b, b)`` their tile view, ``hxb``/``mb``/``s_diag`` all
    (nt, b).

    With a leading dataset axis (``xn: (B, p, n)``, ``c: (B, p, p)``,
    ``mask: (B, p)``, ``n_valid`` None or (B,)) every output gains it too,
    and the whole bucket is one set of torch ops: the diagonal tiles of all
    datasets are scored together, each with its dataset's valid count."""
    *lead, p, n = xn.shape
    b = min(block, max(p, 1))
    pad = (-p) % b
    nt = (p + pad) // b
    xpad = F.pad(xn.to(torch.float32), (0, 0, 0, pad))
    mb = torch.cat([mask, mask.new_zeros(*lead, pad)], dim=-1).reshape(*lead, nt, b)
    cp = F.pad(c.to(torch.float32), (0, pad, 0, pad))
    c4 = cp.reshape(*lead, nt, b, nt, b).transpose(-3, -2)  # (..., nt, nt, b, b)
    hx = row_entropies(xn, mask, n_valid=n_valid)
    hxb = F.pad(hx.to(torch.float32), (0, pad)).reshape(*lead, nt, b)
    c_diag = c4.diagonal(dim1=-4, dim2=-3).movedim(-1, -3)  # (..., nt, b, b)
    tile_nv = n_valid
    if lead and n_valid is not None:  # one count per dataset -> per tile
        tile_nv = torch.as_tensor(n_valid, device=xn.device).repeat_interleave(nt)
    s_diag = diag_block_scores(xpad.reshape(-1, b, n), c_diag.reshape(-1, b, b),
                               hxb.reshape(-1, b), mb.reshape(-1, b),
                               n_valid=tile_nv).reshape(*lead, nt, b)
    return xpad, cp, c4, hxb, mb, s_diag


def tri_tile_partials(xb, c4, hxb, mb, imap, jmap, n_valid=None):
    """Per-tile partial scores of the triangular sweep: for tile t, the row
    sums of the forward credits of block pair (imap[t], jmap[t]) and the
    column sums of the reverse credits. Returns ``(fwd, rev)``, each (T, b),
    built in chunks of tiles."""
    nt, b, n = xb.shape
    step = max(1, _chunk_elems(xb) // max(b * b * n, 1))
    fwd, rev = [], []
    for t0 in range(0, imap.numel(), step):
        i, j = imap[t0:t0 + step], jmap[t0:t0 + step]
        hr_f, hr_r = residual_entropy_block_pair(xb[i], c4[i, j], xb[j],
                                                 n_valid=n_valid)
        stat = (hxb[j][:, None, :] - hxb[i][:, :, None]) + (hr_f - hr_r)
        f, r = _credits(stat, mb[i][:, :, None] & mb[j][:, None, :])
        fwd.append(torch.sum(f, dim=2))
        rev.append(torch.sum(r, dim=1))
    return torch.cat(fwd), torch.cat(rev)


def fused_scores(xn, c, mask, block: int = 32, n_valid=None):
    """Score vector S with no (p, p) HR round-trip — the plain version of
    the fused triangular kernel.

    Triangular block sweep: each unordered (bi, bj) block pair is visited
    once; both residual-entropy directions are computed from the same loads,
    the antisymmetric stat and the messaging credit ``min(0, ±I)^2`` are
    applied immediately, and only per-tile partial score vectors survive.
    Each row block then adds its partials in ascending tile order with a
    select-and-sum (deterministic: no scatter-add atomics on the card)."""
    p, n = xn.shape
    xpad, _, c4, hxb, mb, s2 = fused_layout(xn, c, mask, block, n_valid=n_valid)
    nt, b = mb.shape
    if nt > 1:
        imap, jmap = torch.triu_indices(nt, nt, 1, device=xn.device)
        f, r = tri_tile_partials(xpad.reshape(nt, b, n), c4, hxb, mb, imap,
                                 jmap, n_valid=n_valid)
        rows = torch.arange(nt, device=xn.device)[:, None]
        tri = (torch.where((imap[None, :] == rows)[..., None], f[None], 0.0)
               + torch.where((jmap[None, :] == rows)[..., None], r[None], 0.0))
        s2 = s2 + torch.sum(tri, dim=1)
    s = s2.reshape(nt * b)[:p]
    return torch.where(mask, s, torch.inf)


def residual_entropy_matrix(xn, c, n_valid=None):
    """Full HR: (p, p), computed in column chunks to bound the (p, cols, n)
    buffer (the chunking does not change the arithmetic: each entry is its
    own reduction over the samples)."""
    p, n = xn.shape
    step = max(1, _chunk_elems(xn) // max(p * n, 1))
    return torch.cat(
        [residual_entropy_block(xn, c[:, j0:j0 + step], xn[j0:j0 + step],
                                n_valid=n_valid)
         for j0 in range(0, p, step)],
        dim=1,
    )


def pair_stat_matrix(hx, hr):
    """Antisymmetric likelihood-ratio matrix I (paper Eq. 7)."""
    return (hx[..., None, :] - hx[..., :, None]) + (hr - hr.transpose(-1, -2))


def scores_from_stats(stat, mask):
    """S[i] = sum_j min(0, I_ij)^2 over live pairs; +inf for dead rows.
    Takes leading dataset axes: ``stat: (..., p, p)``, ``mask: (..., p)``."""
    eye = torch.eye(stat.shape[-1], dtype=torch.bool, device=stat.device)
    pair_mask = mask[..., :, None] & mask[..., None, :] & ~eye
    s = torch.sum(_credits(stat, pair_mask)[0], dim=-1)
    return torch.where(mask, s, torch.inf)


def row_entropies(xn, mask, n_valid=None, group=None):
    """H_hat of each (already normalized) row; 0 on dead rows. ``group``:
    the rows hold sample shards (see the module docstring)."""
    return torch.where(mask, stream_entropy(xn, n_valid=n_valid, group=group), 0.0)


def dense_scores(xn, c, mask, n_valid=None):
    """One-shot dense score vector (the square 'Block Compare' analogue, with
    messaging folded in). Returns (S, I, HR)."""
    hx = row_entropies(xn, mask, n_valid=n_valid)
    hr = residual_entropy_matrix(xn, c, n_valid=n_valid)
    stat = pair_stat_matrix(hx, hr)
    return scores_from_stats(stat, mask), stat, hr

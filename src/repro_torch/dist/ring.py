"""ParaLiNGAM's worker decomposition as a point-to-point ring over
``torch.distributed``.

The paper assigns each of the p "workers" (variables) to a CUDA thread block;
here each *rank* (one process, one device) owns a contiguous block of rows of
the normalized data ``xn: (p, n)`` and the matching rows of the correlation
matrix ``c: (p, p)``. Root-finding needs, for every live unordered pair
(i, j), the antisymmetric statistic (paper Eq. 7, via ``core/pairwise.py``)

    I[i, j] = (Hx[j] - Hx[i]) + (HR[i, j] - HR[j, i])

whose two residual entropies need *both* rows' samples. Instead of gathering
the data, row blocks circulate around a ring: at step t each rank computes
the I block between its own rows and the visiting block, adds
``min(0, I)^2`` into its own scores, and adds ``min(0, -I)^2`` into a score
accumulator that travels *with* the visiting block: the paper's messaging
mechanism (Section 3.1), one evaluation credits both endpoints.

Schedule: P pods of R shards each, the hop plan of
``utils.schedule.make_hier_plan`` (``P=1`` is the flat ring: after ``R // 2``
processed steps every unordered block pair has met once, the antipodal step
of an even R kept by the lower-indexed rank). Blocks circulate the intra-pod
ring every hop and cross the pod boundary once per intra-pod revolution; the
epoch-entry packet is the packet the next epoch starts from, so the
cross-pod shift is posted at the epoch's start. Every shift is one
``batch_isend_irecv`` from a single source rank, posted before the compute
that precedes its use (hop k+1 is posted before hop k is computed and waited
on only when used); the credit and done riders, which depend on each hop's
compute, move sequentially. The bodies count their shifts by kind into a
(4,) tally (``schedule.HOP_*``: intra/cross x overlapped/sequential) at the
call sites, so the counters equal ``HierPlan.hop_counts`` by construction.

A rank that does not keep a self-conjugate (dedup) hop's pairs computes
nothing there: the other endpoint does. So per find-root a rank launches the
square moments kernel once for its own block and twice for every hop it
keeps. Both ``hopper`` score backends run that kernel (the fused kernel
finalizes its scores in-kernel and has no sums to reduce across sample
shards); ``torch`` and ``torch_fused`` the plain moments.

The mesh is a ``DeviceMesh`` with dimensions ``("pod", "ring", "model")``
(a leading ``"replica"`` dimension for ranks that run the ring replicated):
rows over pod-major flat index ``q * R + i``, samples over ``model``. Without
a mesh the ring has one shard and calls no collective.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.pairwise import (
    _credits,
    pair_moments,
    pair_stat_matrix,
    residual_entropy_block,
    row_entropies,
)
from repro_torch.dist.sharding import mesh_sizes
from repro_torch.utils.schedule import (
    HOP_CROSS_OVL,
    HOP_CROSS_SEQ,
    HOP_INTRA_OVL,
    HOP_INTRA_SEQ,
    make_hier_plan,
)

#: Dimensions of the ring's canonical mesh, outermost first: P pods of R
#: intra-pod row shards, the samples over ``model``.
RING_DIMS = ("pod", "ring", "model")
INTRA, CROSS = "ring", "pod"


# ---------------------------------------------------------------------------
# schedule (pure, unit-testable)
# ---------------------------------------------------------------------------


def ring_steps(r: int) -> int:
    """Number of processed ring steps (excluding the intra-block step 0)."""
    return r // 2


def process_pair(r: int, t: int, dst, src):
    """Whether rank ``dst`` processes the block from ``src`` at step ``t``.

    For even ``r`` the antipodal step ``t == r/2`` delivers each block pair
    to both endpoints simultaneously; the lower-indexed rank keeps it."""
    if t < 1 or t > ring_steps(r):
        return False
    if r % 2 == 0 and t == r // 2:
        return dst < src
    return True


# ---------------------------------------------------------------------------
# the ring's view of the mesh
# ---------------------------------------------------------------------------


class _Pending:
    """A packet in flight: a dict of tensors that ``wait`` returns once its
    receives (and this rank's sends) have completed, each moved to ``to``
    when it was received in a host buffer (``Shards.shift``'s staging)."""

    def __init__(self, packet=None, works=(), sent=(), to=None):
        # ``sent`` keeps the tensors being sent alive until the sends end.
        self._packet, self._works, self._sent, self._to = packet, list(works), sent, to

    def wait(self) -> dict:
        for w in self._works:
            w.wait()
        if self._to is not None:
            self._packet = {k: v.to(self._to) for k, v in self._packet.items()}
        self._works, self._sent, self._to = [], (), None
        return self._packet


class Shards:
    """This rank's place in the ring's canonical mesh and the collectives the
    ring bodies and the order driver use. ``mesh=None``: one shard, no
    collective. ``sample_sharded``: the rows hold this rank's equal shard of
    the samples, summed across ``model``."""

    def __init__(self, mesh=None, sample_sharded: bool = False):
        self.mesh = mesh
        sizes = mesh_sizes(mesh)
        self.pods, self.ring, self.model = (sizes.get(d, 1) for d in RING_DIMS)
        self.sample_group = None
        self._host_transport = False
        if mesh is None:
            self.coord = {}
            return
        names = mesh.mesh_dim_names
        self._ranks = mesh.mesh.tolist()  # the rank table, read without torch ops
        self.coord = dict(zip(names, mesh.get_coordinate()))
        self._dim = {d: names.index(d) for d in RING_DIMS}
        self._groups = {d: mesh.get_group(d) for d in RING_DIMS}
        # Gathered chunks arrive in group-rank order; hold them in mesh
        # coordinate order whatever the group's rank order.
        self._order = {}
        for d, g in self._groups.items():
            where = [slice(None)] * len(names)
            for k, v in self.coord.items():
                if k != d:
                    where[names.index(k)] = v
            line = mesh.mesh[tuple(where)].tolist()
            self._order[d] = [dist.get_group_rank(g, r) for r in line]
        if sample_sharded and self.model > 1:
            self.sample_group = self._groups["model"]
        self._host_transport = dist.get_backend() == "gloo"

    @property
    def q(self) -> int:
        return self.coord.get("pod", 0)

    @property
    def i(self) -> int:
        return self.coord.get("ring", 0)

    @property
    def flat(self) -> int:
        """This rank's row-block index ``q * R + i``, pod-major."""
        return self.q * self.ring + self.i

    @property
    def blocks(self) -> int:
        return self.pods * self.ring

    def _rank_at(self, dim: str, coord: int) -> int:
        where = [self.coord[k] for k in self.mesh.mesh_dim_names]
        where[self._dim[dim]] = coord
        rank = self._ranks
        for i in where:
            rank = rank[i]
        return rank

    def shift(self, packet, s: int, dim: str) -> _Pending:
        """Shift a packet (a dict of tensors, or a pending one) ``s`` hops
        along ``dim`` (``INTRA`` or ``CROSS``): this rank receives the packet
        of the rank ``s`` behind it and sends its own ``s`` ahead, one
        ``batch_isend_irecv`` posted now.

        The transport's rule: gloo moves host memory only (its send and
        receive hand the tensor's pointer to a socket, whatever the
        device), so under a gloo process group a packet on the card is
        sent from host copies and received into host buffers, which
        ``wait`` moves back to the card. Under NCCL device tensors go
        straight. A failed transfer raises either way."""
        if isinstance(packet, _Pending):
            packet = packet.wait()
        size = self.ring if dim == INTRA else self.pods
        s %= size
        if self.mesh is None or s == 0:
            return _Pending(packet)
        me = self.coord[dim]
        dst, src = self._rank_at(dim, (me + s) % size), self._rank_at(dim, (me - s) % size)
        dev = next(iter(packet.values())).device
        to = dev if dev.type != "cpu" and self._host_transport else None
        out, ops, sent = {}, [], []
        for k in sorted(packet):
            sent.append(packet[k].contiguous() if to is None else packet[k].cpu())
            out[k] = torch.empty_like(sent[-1])
            ops += [dist.P2POp(dist.isend, sent[-1], dst), dist.P2POp(dist.irecv, out[k], src)]
        return _Pending(out, dist.batch_isend_irecv(ops), sent, to)

    def _gather(self, t, dim: str):
        g = self._groups[dim]
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t.contiguous(), group=g)
        return torch.cat([parts[k] for k in self._order[dim]])

    def gather_rows(self, t):
        """Concatenate every row block's ``t`` (leading axis) in flat block
        order: an ``all_gather`` over ``ring``, then over ``pod``, each only
        where that dimension has more than one rank (a group of one is the
        identity: ``t`` itself, no collective)."""
        for d, size in ((INTRA, self.ring), (CROSS, self.pods)):
            if self.mesh is not None and size > 1:
                t = self._gather(t, d)
        return t

    def sum_rows(self, t):
        """``t`` summed over every row block (``all_reduce`` over ``ring``,
        then ``pod``, each only where that dimension has more than one
        rank: with neither, ``t`` itself); exact where one block holds a
        value and the others zeros, and for counts."""
        src = t
        for d, size in ((INTRA, self.ring), (CROSS, self.pods)):
            if self.mesh is not None and size > 1:
                t = t.clone() if t is src else t
                dist.all_reduce(t, group=self._groups[d])
        return t


# ---------------------------------------------------------------------------
# the dense ring body
# ---------------------------------------------------------------------------


def _block_stat(x_own, x_vis, c_block, hx_own, hx_vis, live_own, live_vis,
                backend: str, group=None):
    """I block between own rows (rows of the result) and visiting rows.

    ``c_block[i, j] = c[own_i, vis_j]``. Both residual entropies of each pair
    come from here, HR[i, j] and HR[j, i], which is what lets one evaluation
    credit both endpoints. The kernel sums only live pairs; ``group`` sums
    the moments of the sample shards before the entropy."""
    hr_fwd = residual_entropy_block(x_own, c_block, x_vis, backend=backend,
                                    live_i=live_own, live_j=live_vis, group=group)
    hr_rev = residual_entropy_block(x_vis, c_block.T, x_own, backend=backend,
                                    live_i=live_vis, live_j=live_own, group=group)
    return (hx_vis[None, :] - hx_own[:, None]) + (hr_fwd - hr_rev.T)


def _ring_body(x_loc, c_loc, mask, shards: Shards, backend: str = "torch"):
    """One rank's dense ring sweep. ``x_loc: (m, n_loc)`` and ``c_loc:
    (m, P*R*m)`` are this rank's row block; ``mask: (P*R*m,)`` is the live
    mask of every row (the same on every rank).

    Returns ``(score, hops)``: the (m,) score shard (+inf on dead rows) and
    the (4,) count of the shifts this sweep issued (``schedule.HOP_*``)."""
    m = x_loc.shape[0]
    group = shards.sample_group
    plan = make_hier_plan(shards.pods, shards.ring)
    d_idx = shards.flat
    mask_loc = mask[d_idx * m:(d_idx + 1) * m]
    hx_loc = row_entropies(x_loc, mask_loc, group=group)

    # Offset (0, 0): intra-block pairs. One entropy pass gives the full HR
    # block; the antisymmetric stat is hr - hr.T, so the row sum alone
    # credits every ordered pair.
    hr = residual_entropy_block(x_loc, c_loc[:, d_idx * m:(d_idx + 1) * m], x_loc,
                                backend=backend, live_i=mask_loc, live_j=mask_loc,
                                group=group)
    eye = torch.eye(m, dtype=torch.bool, device=x_loc.device)
    pm = mask_loc[:, None] & mask_loc[None, :] & ~eye
    score = torch.sum(_credits(pair_stat_matrix(hx_loc, hr), pm)[0], dim=1)

    tally = [0, 0, 0, 0]

    def shift(packet, s, dim, kind):
        tally[kind] += 1
        return shards.shift(packet, s, dim)

    # The plan walk. The visiting block (data and entropies) never changes,
    # so its movement is overlapped: hop t+1's shift is posted before hop
    # t's compute, and the cross-pod exchange for the next epoch at this
    # epoch's start. The credit accumulator, which the compute changes, is
    # a (m,) rider shifted after each hop's credits are known.
    acc = prev = None
    cur = _Pending({"x": x_loc, "hx": hx_loc})
    for eidx, (e, ts) in enumerate(plan.epochs):
        nxt_entry = (shift(cur, 1, CROSS, HOP_CROSS_OVL)
                     if eidx + 1 < len(plan.epochs) else None)
        pos = 0
        for j, (t, dedup) in enumerate(ts):
            if pos != t:  # advance the packet to this hop's offset
                cur = shift(cur, 1, INTRA, HOP_INTRA_OVL)
                pos = t
            nxt = shift(cur, 1, INTRA, HOP_INTRA_OVL) if j + 1 < len(ts) else None
            src = plan.src(e, t, shards.q, shards.i)
            rev = torch.zeros_like(score)
            vis = cur.wait()  # every posted shift is waited on, kept or not
            if plan.keep(dedup, d_idx, src):
                mask_vis = mask[src * m:(src + 1) * m]
                stat = _block_stat(x_loc, vis["x"], c_loc[:, src * m:(src + 1) * m],
                                   hx_loc, vis["hx"], mask_loc, mask_vis, backend, group)
                fwd, rev = _credits(stat, mask_loc[:, None] & mask_vis[None, :])
                score = score + torch.sum(fwd, dim=1)
                rev = torch.sum(rev, dim=0)
            # acc rides with the block: after hop (e, t) it holds every
            # credit for block (q - e, i - t).
            if acc is None:
                acc = rev
            else:
                acc = _ride(shift, {"acc": acc}, (t - prev[1]) % shards.ring,
                            (e - prev[0]) % shards.pods)["acc"] + rev
            prev = (e, t)
            if nxt is not None:
                cur, pos = nxt, t + 1
        cur = nxt_entry
    if acc is not None:  # ride home: each block's credits land at its owner
        score = score + _ride(shift, {"acc": acc}, -prev[1] % shards.ring,
                              -prev[0] % shards.pods)["acc"]
    return torch.where(mask_loc, score, torch.inf), tuple(tally)


# ---------------------------------------------------------------------------
# the threshold ring body
# ---------------------------------------------------------------------------


def _at(shape, rows, cols, vals):
    """A zeroed ``shape`` buffer holding ``vals`` at the unique positions
    ``(rows, cols)``: summing it over an axis adds the values of each
    target in a fixed order (no duplicate-index scatter-add, whose CUDA
    atomics reorder the sum)."""
    return torch.zeros(shape, dtype=vals.dtype, device=vals.device).index_put((rows, cols), vals)


def _mark(d, rows, cols, keep):
    """``d[rows, cols] |= keep`` at unique positions."""
    return d.index_put((rows, cols), d[rows, cols] | keep)


def _ring_threshold_body(x_loc, c_loc, mask, shards: Shards, *, gamma0: float = 1e-5,
                         gamma_growth: float = 2.0, chunk: int = 16,
                         max_rounds: int = 100_000):
    """The paper's threshold state machine (Algorithms 4-6) run per ring
    shard, in place of one dense ``_ring_body`` sweep. Arguments as there.

    Per-rank state is the host machine's restricted to the own rows: an
    (m_l,) score shard, an (m_l, m) done matrix over every column, and
    gamma, rounds and the terminal flag, the same on every rank. One cycle is
    a full ring pass:

      * hop 0 processes intra-block pending pairs (two workers proposing the
        same pair keep the lower index: Algorithm 6 line 22);
      * each processed hop of the plan processes the visiting block: every
        *active* own row (below gamma, unfinished, live) takes its first
        pending chunk of the visitor's columns, and every active *visiting*
        row (its departure score and finished bit ride the packet, plus the
        credits earned this cycle) its first pending chunk of the host's
        columns, less this hop's host picks, so that no pair waits on its
        host row's activity;
      * credits to the visiting rows and their symmetric done marks ride the
        packet home as riders (an (m_l,) credit vector, an (m_l, m) done
        update).

    The cycle's epilogue sums the kept comparisons over every row block (none
    processed: gamma grows by ``gamma_growth``, Algorithm 6 lines 15-17) and
    the below-gamma finished and unfinished counts (Algorithm 6's
    termination), so every rank ends the same cycle. At termination every
    below-gamma worker's score is complete and every paused worker's partial
    score only grows, so ``argmin`` over the gathered scores is the root.
    The loop reads the terminal flag on the host once per cycle.

    Returns ``(scores, comparisons, rounds, converged, hops)``: the (m_l,)
    score shard (+inf on dead rows), the summed comparisons (a device
    int64), rounds, whether Algorithm 6's condition held before
    ``max_rounds`` (or there were no pairs), and the (4,) shift counts: the
    rounds times one cycle's."""
    dev = x_loc.device
    group = shards.sample_group
    m_l = x_loc.shape[0]
    m = mask.shape[0]
    plan = make_hier_plan(shards.pods, shards.ring)
    r_idx = shards.flat
    mask_loc = mask[r_idx * m_l:(r_idx + 1) * m_l]
    hx_loc = row_entropies(x_loc, mask_loc, group=group)
    own_gid = r_idx * m_l + torch.arange(m_l, device=dev)
    pv = mask_loc[:, None] & mask[None, :] & (own_gid[:, None] != torch.arange(m, device=dev))
    has_pairs = int(mask.sum()) >= 2

    # The chunk rounded down to a divisor of the block, so the visiting
    # columns reshape into whole chunks (worst case 1, the paper's
    # one-at-a-time worker).
    b = max(1, min(chunk, m_l))
    while m_l % b:
        b -= 1
    nc = m_l // b
    rows = torch.arange(m_l, device=dev)[:, None].expand(m_l, b)
    offs = torch.arange(b, device=dev)

    def first_chunk(pending):
        """Each row's first chunk with a pending column: (m_l, b) columns."""
        pend = torch.any(pending.reshape(m_l, nc, b), dim=2)
        return torch.argmax(pend.to(torch.int8), dim=1)[:, None] * b + offs

    def chunk_stats(need, x_rows, c_vals, x_cols, hx_rows, hx_cols):
        """The stat of each (row, chunk column) of the rows in ``need``
        (zero elsewhere: no other row proposes, so no other entry is kept).
        ``x_cols`` is indexed by ``idx`` before the gather, so only the
        proposing rows' (b, n) chunks are built; every rank of a sample
        group has the same ``need``."""
        stat = torch.zeros((m_l, b), dtype=x_loc.dtype, device=dev)
        idx = torch.nonzero(need).squeeze(1)
        if idx.numel():
            hr_fwd, hr_rev = pair_moments(x_rows[idx], c_vals[idx], x_cols(idx), group=group)
            stat[idx] = (hx_cols[idx] - hx_rows[idx, None]) + (hr_fwd - hr_rev)
        return stat

    def hop(s, d, gamma, comps, credit, done, vis, src, intra: bool):
        """Process one visiting block (``intra``: the own block). Returns the
        own state and the visitor's riders."""
        col0 = src * m_l
        vis_gid = col0 + torch.arange(m_l, device=dev)
        mask_vis = mask[col0:col0 + m_l]
        pv_vis = (mask_loc[:, None] & mask_vis[None, :]
                  & (own_gid[:, None] != vis_gid[None, :]))
        pending = ~d[:, col0:col0 + m_l] & pv_vis
        active = (s < gamma) & ~torch.all(d, dim=1) & mask_loc

        # host-initiated: each active own row's first pending chunk
        cols = first_chunk(pending)
        cols_g = col0 + cols
        proc = active[:, None] & torch.take_along_dim(pending, cols, dim=1)
        stat = chunk_stats(torch.any(proc, dim=1), x_loc,
                           torch.take_along_dim(c_loc, cols_g, dim=1),
                           lambda idx: vis["x"][cols[idx]], hx_loc, vis["hx"][cols])
        if intra:  # both endpoints resident: the lower index keeps a mutual pick
            prop = _at((m_l, m_l), rows, cols, proc)
            keep = proc & (~torch.take_along_dim(prop.T, cols, dim=1) | (rows < cols))
        else:
            keep = proc
        fwd, rev = _credits(stat, keep)
        s2 = s + torch.sum(fwd, dim=1)
        d2 = _mark(d, rows, cols_g, keep)
        comps = comps + torch.sum(keep)
        if intra:  # both endpoints own: credit and the symmetric mark here
            s2 = s2 + torch.sum(_at((m_l, m_l), rows, cols, rev), dim=0)
            return s2, _mark(d2, cols, own_gid[rows], keep), comps, credit, done
        credit2 = credit + torch.sum(_at((m_l, m_l), rows, cols, rev), dim=0)
        done2 = _mark(done, cols, own_gid[rows], keep)

        # visitor-initiated: each active visiting row's first pending chunk
        # of the host's columns, less this hop's host picks. Its partial
        # score is its departure score plus this cycle's credits so far.
        pending2 = pending.T & ~_at((m_l, m_l), rows, cols, keep).T  # (vis, own)
        cols2 = first_chunk(pending2)
        act_vis = (vis["s0"] + credit < gamma) & ~vis["fin"] & mask_vis
        keep2 = act_vis[:, None] & torch.take_along_dim(pending2, cols2, dim=1)
        stat2 = chunk_stats(torch.any(keep2, dim=1), vis["x"], c_loc[cols2, vis_gid[:, None]],
                            lambda idx: x_loc[cols2[idx]], vis["hx"], hx_loc[cols2])
        fwd2, rev2 = _credits(stat2, keep2)
        s2 = s2 + torch.sum(_at((m_l, m_l), rows, cols2, rev2), dim=0)
        d2 = _mark(d2, cols2, vis_gid[rows], keep2)
        credit2 = credit2 + torch.sum(fwd2, dim=1)
        done2 = _mark(done2, rows, own_gid[cols2], keep2)
        return s2, d2, comps + torch.sum(keep2), credit2, done2

    s = torch.where(mask_loc, 0.0, torch.inf).to(x_loc.dtype)
    d = ~pv
    gamma = torch.tensor(gamma0, dtype=x_loc.dtype, device=dev)
    comparisons = torch.zeros((), dtype=torch.int64, device=dev)
    rounds, terminal = 0, False
    cycle_tally = (0, 0, 0, 0)

    while has_pairs and not terminal and rounds < max_rounds:
        comps = torch.zeros((), dtype=torch.int64, device=dev)
        credit = torch.zeros((m_l,), dtype=x_loc.dtype, device=dev)
        done = torch.zeros((m_l, m), dtype=torch.bool, device=dev)
        tally = [0, 0, 0, 0]

        def shift(packet, sft, dim, kind):
            tally[kind] += 1
            return shards.shift(packet, sft, dim)

        s, d, comps, _, _ = hop(s, d, gamma, comps, credit, done,
                                {"x": x_loc, "hx": hx_loc}, r_idx, True)

        # The plan walk: the packet that never changes within a cycle (data,
        # entropies, departure score and finished bits) on the overlapped
        # schedule; the credit and done riders catch up sequentially, right
        # before the hop that uses them.
        cur = _Pending({"x": x_loc, "hx": hx_loc, "s0": s, "fin": torch.all(d, dim=1)})
        prev = None
        for eidx, (e, ts) in enumerate(plan.epochs):
            nxt_entry = (shift(cur, 1, CROSS, HOP_CROSS_OVL)
                         if eidx + 1 < len(plan.epochs) else None)
            pos = 0
            for j, (t, dedup) in enumerate(ts):
                if pos != t:
                    cur = shift(cur, 1, INTRA, HOP_INTRA_OVL)
                    pos = t
                nxt = shift(cur, 1, INTRA, HOP_INTRA_OVL) if j + 1 < len(ts) else None
                if prev is not None:
                    riders = _ride(shift, {"credit": credit, "done": done},
                                   (t - prev[1]) % shards.ring, (e - prev[0]) % shards.pods)
                    credit, done = riders["credit"], riders["done"]
                src = plan.src(e, t, shards.q, shards.i)
                vis = cur.wait()  # every posted shift is waited on, kept or not
                if plan.keep(dedup, r_idx, src):  # else the other endpoint does it
                    s, d, comps, credit, done = hop(s, d, gamma, comps, credit, done,
                                                    vis, src, False)
                prev = (e, t)
                if nxt is not None:
                    cur, pos = nxt, t + 1
            cur = nxt_entry
        if prev is not None:  # the riders ride home
            riders = _ride(shift, {"credit": credit, "done": done}, -prev[1] % shards.ring,
                           -prev[0] % shards.pods)
            s = s + riders["credit"]
            d = d | riders["done"]
        cycle_tally = tuple(tally)

        # Epilogue: gamma and termination, the same on every rank.
        processed = shards.sum_rows(comps)
        gamma = torch.where(processed > 0, gamma, gamma * gamma_growth)
        fin = torch.all(d, dim=1)
        below = (s < gamma) & mask_loc
        counts = shards.sum_rows(torch.stack([torch.sum(below & fin), torch.sum(below & ~fin)]))
        comparisons = comparisons + processed
        rounds += 1
        terminal = bool((counts[0] > 0) & (counts[1] == 0))

    hops = tuple(rounds * v for v in cycle_tally)
    return torch.where(mask_loc, s, torch.inf), comparisons, rounds, terminal or not has_pairs, hops


def _ride(shift, riders: dict, ds: int, de: int) -> dict:
    """Move riders, which depend on each hop's compute, ``ds`` intra and
    ``de`` cross hops: sequential shifts, waited on at once."""
    if ds:
        riders = shift(riders, ds, INTRA, HOP_INTRA_SEQ).wait()
    if de:
        riders = shift(riders, de, CROSS, HOP_CROSS_SEQ).wait()
    return riders


# ---------------------------------------------------------------------------
# the canonical mesh
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def ring_mesh(mesh, ranks, names=RING_DIMS, device_type: str | None = None):
    """The ``DeviceMesh`` over the global ``ranks`` tensor with dimensions
    ``names``: ``mesh`` itself when it is already that, else one built (a
    collective call: every rank builds it, in the same order) and kept for
    the process group's life, so repeated calls create no new groups. Its
    device type is ``device_type``, else ``mesh``'s, else ``cuda``: the
    caller's choice, never read from the process group's backend."""
    ranks = torch.as_tensor(ranks, dtype=torch.int64)
    if device_type is None:
        device_type = mesh.device_type if mesh is not None else "cuda"
    if (mesh is not None and tuple(mesh.mesh_dim_names or ()) == tuple(names)
            and mesh.device_type == device_type and torch.equal(mesh.mesh.cpu(), ranks)):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    key = (dist.group.WORLD, device_type, tuple(names), tuple(ranks.shape),
           tuple(ranks.flatten().tolist()))
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))
    return _MESHES[key]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def ring_find_root(xn, c, mask, mesh, row_axes: tuple | None = None,
                   sample_axis: str | None = None, score_backend: str = "auto", *,
                   device=None):
    """Distributed find-root. Returns ``(root, scores)``, the dense
    evaluation's, on every rank.

    ``xn: (p, n)``, ``c: (p, p)`` and ``mask: (p,)`` are the whole problem,
    the same on every rank (each takes its own row block and sample shard).
    ``mesh`` is a ``DeviceMesh``; ``row_axes`` names the dimensions the rows
    shard over (default: those of ``pod`` and ``data`` it has), flattened
    row-major into the ring; a leading ``pod`` dimension of size > 1 selects
    the two-level ring (blocks stay pod-major, so the scores' row order is
    the flat ring's). ``sample_axis`` optionally names a dimension to shard
    the samples over (moments summed across it; dropped when it is a row
    dimension, of size 1, or does not divide n). Dimensions in neither set
    run the ring replicated. A degenerate ring (one shard, p not divisible
    by the shard count, or more than two ring dimensions) runs on every rank
    as one shard with no collective: the dense evaluation through the ring's
    own hop-0 block, so a kernel backend still runs the square moments
    kernel. ``score_backend`` selects the per-shard moments
    (``kernels.ops.SCORE_BACKENDS``): both ``hopper`` names run the square
    moments kernel. ``device`` is where it runs: the card unless the caller
    passes ``"cpu"`` (raising without a card); the inputs move there."""
    from repro_torch.core.paralingam import _device
    from repro_torch.kernels import ops as kops

    xn, c, mask = _on(_device(device, "ring_find_root"), xn, c, mask)
    backend = kops.select_backend(score_backend, xn.device)
    return _find_root(xn, c, mask, ring_shards(mesh, *xn.shape, row_axes, sample_axis), backend)


def _on(dev, *ts):
    return tuple(torch.as_tensor(t).to(dev) for t in ts)


def ring_shards(mesh, p: int, n: int, row_axes: tuple | None = None,
                sample_axis: str | None = None) -> Shards:
    """The shards ``ring_find_root`` runs a (p, n) problem on over
    ``mesh`` (its arguments' rules): ``Shards(None)`` for a degenerate
    ring. Builds the ring's mesh from ``mesh``'s rank tensor (a collective
    call the first time)."""
    sizes = mesh_sizes(mesh)
    if row_axes is None:
        row_axes = tuple(a for a in ("pod", "data") if a in sizes)
    row_axes = tuple(a for a in row_axes if sizes.get(a, 1) > 1)
    pod_axes, ring_axes = (), row_axes
    if len(row_axes) >= 2 and row_axes[0] == "pod":
        pod_axes, ring_axes = row_axes[:1], row_axes[1:]
    big_r = math.prod(sizes[a] for a in row_axes)
    if big_r <= 1 or p % big_r or len(ring_axes) > 2:
        return Shards(None)
    if sample_axis is not None and (sample_axis in row_axes or sizes.get(sample_axis, 1) <= 1
                                    or n % sizes[sample_axis]):
        sample_axis = None
    sample_axes = () if sample_axis is None else (sample_axis,)
    rest = tuple(a for a in mesh.mesh_dim_names if a not in row_axes + sample_axes)
    dims = rest + pod_axes + ring_axes + sample_axes
    ranks = mesh.mesh.permute([mesh.mesh_dim_names.index(a) for a in dims])
    shape = (math.prod(sizes[a] for a in pod_axes), math.prod(sizes[a] for a in ring_axes),
             math.prod(sizes[a] for a in sample_axes))
    names = RING_DIMS
    if rest:
        shape, names = (math.prod(sizes[a] for a in rest),) + shape, ("replica",) + RING_DIMS
    return Shards(ring_mesh(mesh, ranks.reshape(shape), names),
                  sample_sharded=sample_axis is not None)


def _find_root(xn, c, mask, shards: Shards, backend: str):
    p, n = xn.shape
    m = p // shards.blocks
    n_loc = n // shards.model if shards.sample_group is not None else n
    mi = shards.coord.get("model", 0) if shards.sample_group is not None else 0
    rows = slice(shards.flat * m, (shards.flat + 1) * m)
    x_loc = xn[rows, mi * n_loc:(mi + 1) * n_loc].contiguous()
    score, _ = _ring_body(x_loc, c[rows].contiguous(), mask, shards, backend=backend)
    scores = shards.gather_rows(score)
    return torch.argmin(scores), scores


def ring_find_root_jit(mesh, score_backend: str = "auto", topology: tuple | None = None, *,
                       device=None):
    """The ring find-root over *every* rank of ``mesh``, as a function of
    ``(xn, c, mask)`` (the JAX package's jitted factory; PyTorch compiles
    nothing, and the name is kept so the counterpart is found).

    By default a mesh without a ``pod`` dimension (or with a size-1 one) is
    flattened into one ring, every rank owning one row block: the paper's
    worker decomposition with workers = ranks. A ``pod`` dimension of size
    > 1 is kept: the other ranks flatten into the intra-pod ring and the
    find-root walks the two-level plan. ``topology=(P, R)`` overrides both
    and must factor the rank count (``ValueError`` otherwise); ``(1, R)``
    forces the flat ring. ``device`` is where ``fn`` runs: the card unless
    the caller passes ``"cpu"`` (raising here without a card); its inputs
    move there."""
    n_dev = mesh.mesh.numel()
    if topology is None:
        pods = mesh_sizes(mesh).get("pod", 1)
        topology = (pods, n_dev // pods)
    pods, ring = topology
    if pods * ring != n_dev:
        raise ValueError(f"topology {topology} does not factor {n_dev} devices")
    from repro_torch.core.paralingam import _device

    dev = _device(device, "ring_find_root_jit")
    shards = Shards(ring_mesh(mesh, mesh.mesh.reshape(pods, ring, 1)))

    def fn(xn, c, mask):
        from repro_torch.kernels import ops as kops

        xn, c, mask = _on(dev, xn, c, mask)
        return _find_root(xn, c, mask, shards, kops.select_backend(score_backend, dev))

    return fn

"""Topology-aware bucket schedule shared by every causal-order driver.

The ParaLiNGAM outer loop shrinks the remaining set U from p rows to 1; to
keep the number of compiled specializations logarithmic, rows are compacted
into power-of-two *buckets*: each stage runs some iterations at a fixed
buffer size m, and the <= log2 p stage transitions compact live rows into
the next smaller buffer. Historically the host driver, the device-resident
scan driver (``core.paralingam._scan_order_impl``) and the ring driver
(``dist.ring_order``) each derived this plan separately — and the ring's
extra constraint (m must stay a multiple of the ring size R so the per-shard
row blocks stay equal and non-empty) lived only in the ring module, so the
scan and ring plans could silently drift.

:class:`Schedule` is the single source of truth: one object that knows the
problem size p, the bucket floor, and the topology (pod count P, ring size
R, sample shards M), and emits the stage plan every driver consumes.
Invariants (enforced at construction, property-tested in
tests/test_schedule.py):

  * every stage size m is a power of two and a multiple of ``pods * ring``
    (the total shard count — every shard keeps an equal non-empty block);
  * stage m covers every iteration it spans: m >= live-row count r for each
    of its iterations (coverage — no compaction ever drops a live row);
  * iteration counts sum to p - 1 (the last live row needs no find-root);
  * ``ring=1`` reproduces the scan driver's plan exactly (scan == ring at
    R=1), so the two drivers cannot diverge;
  * the plan depends only on ``pods * ring``, so every (P, R) split of the
    same shard count compacts at the same iterations — hierarchical and
    flat rings of equal width recover bit-identical orders.

:class:`HierPlan` is the hop-level companion for the two-level
``("pod", "ring")` messaging ring: which (pod offset e, intra offset t)
hops each device processes, the antipodal-dedup predicate across both
levels (every unordered block pair lands on exactly one hosting endpoint
per iteration), the pod-exchange cadence (one cross-pod shift per intra-pod
revolution), and the analytic wire model the device-measured hop counters
are asserted against.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.utils.shapes import next_pow2


@dataclass(frozen=True)
class Schedule:
    """Static stage plan of one causal-order recovery.

    ``stages`` is a tuple of ``(m, count)`` pairs: run ``count`` outer
    iterations at buffer size ``m``, then compact into the next stage's
    buffer. Hashable and immutable so jitted drivers can key their caches on
    it directly."""

    p: int  # problem size (number of variables)
    min_bucket: int  # bucket floor requested by the config
    ring: int = 1  # intra-pod ring shard count R (the full ring width for
    #   flat rings — ``pods=1`` — which is every pre-hierarchical caller)
    pods: int = 1  # pod count P of the two-level ring; total shard count is
    #   ``pods * ring`` and every stage buffer divides over it
    sample_shards: int = 1  # model-axis shard count M (bookkeeping only —
    #   the samples axis never compacts, but the (P, R, M) triple identifies
    #   the topology a plan was built for, and the analytic HBM/wire model in
    #   EXPERIMENTS.md reads all three factors off the schedule)
    stages: tuple[tuple[int, int], ...] = field(default=())

    def __post_init__(self):
        if self.ring < 1 or self.ring & (self.ring - 1):
            raise ValueError(f"ring size must be a power of two, got {self.ring}")
        if self.pods < 1 or self.pods & (self.pods - 1):
            raise ValueError(f"pod count must be a power of two, got {self.pods}")
        if self.sample_shards < 1:
            raise ValueError(f"sample_shards must be >= 1, got {self.sample_shards}")
        # Coverage + divisibility invariants: cheap, and they turn schedule
        # bugs into construction-time errors instead of silent wrong orders.
        r = self.p
        for m, cnt in self.stages:
            if m & (m - 1):
                raise ValueError(f"stage size {m} is not a power of two")
            if m % (self.pods * self.ring):
                raise ValueError(
                    f"stage size {m} is not a multiple of ring="
                    f"{self.pods * self.ring}")
            if m < r:
                raise ValueError(
                    f"stage size {m} cannot cover {r} live rows")
            r -= cnt
        if sum(c for _, c in self.stages) != max(self.p - 1, 0):
            raise ValueError(
                f"stage counts {self.stages} do not sum to p-1={self.p - 1}")

    @property
    def shards(self) -> int:
        """Total shard count P * R of the (possibly two-level) ring."""
        return self.pods * self.ring

    @property
    def total_iterations(self) -> int:
        """Find-root iterations the plan covers (p - 1; the final live row
        retires without one)."""
        return sum(cnt for _, cnt in self.stages)

    @property
    def num_compactions(self) -> int:
        """Stage transitions where rows move (bounded by log2 p)."""
        return max(len(self.stages) - 1, 0)

    def block(self, m: int) -> int:
        """Per-shard row-block size at stage buffer size ``m``."""
        return m // (self.pods * self.ring)

    def walk(self):
        """Yield ``(m, count, pos)`` per stage, ``pos`` the index of the
        stage's first outer iteration — the loop shape both the scan and
        ring drivers are written around."""
        pos = 0
        for m, cnt in self.stages:
            yield m, cnt, pos
            pos += cnt

    def live_at(self, pos: int) -> int:
        """Live-row count entering outer iteration ``pos`` (full buffers;
        padded datasets may run with fewer — they drain early)."""
        return self.p - pos


def make_schedule(p: int, min_bucket: int, ring: int = 1, pods: int = 1,
                  sample_shards: int = 1) -> Schedule:
    """Build the power-of-two bucket schedule for one recovery.

    The plan mirrors the host driver's bucketing: iteration at r live rows
    runs in a buffer of size ``next_pow2(r)``, floored at
    ``next_pow2(max(min_bucket, pods * ring))`` (the shard floor keeps every
    shard's block non-empty) and capped at ``next_pow2(p)``. Consecutive
    equal sizes merge into stages. A ring wider than the padded problem
    degenerates to a single stage of size ``pods * ring`` — one row (or
    less) per shard, the excess dead from the start. ``ring=1`` is exactly
    the scan plan, and the stages depend only on the product ``pods * ring``
    — every (P, R) factorization of one shard count shares one plan."""
    if ring < 1 or ring & (ring - 1):
        raise ValueError(f"ring size must be a power of two, got {ring}")
    if pods < 1 or pods & (pods - 1):
        raise ValueError(f"pod count must be a power of two, got {pods}")
    shards = pods * ring
    if p <= 1:
        stages: tuple[tuple[int, int], ...] = ()
    elif shards > next_pow2(p):
        stages = ((shards, p - 1),)
    else:
        cap = next_pow2(p)
        floor = next_pow2(max(min_bucket, shards, 1))
        ms = [min(cap, max(floor, next_pow2(r))) for r in range(p, 1, -1)]
        stages = tuple((m, len(list(g))) for m, g in itertools.groupby(ms))
    return Schedule(p=p, min_bucket=min_bucket, ring=ring, pods=pods,
                    sample_shards=sample_shards, stages=stages)


# ---------------------------------------------------------------------------
# the two-level ("pod", "ring") hop plan
# ---------------------------------------------------------------------------

#: Indices into the (4,) hop-counter vector threaded out of the ring bodies
#: (``dist.ring``) and through ``ParaLiNGAMResult.wire``: intra-pod /
#: cross-pod ppermute rounds, split by whether the round is *overlapped*
#: (issued before the compute that consumes it — the double-buffered block
#: packet and the epoch-start pod exchange) or *sequential* (the credit/done
#: riders, which depend on the previous hop's compute).
HOP_INTRA_OVL, HOP_INTRA_SEQ, HOP_CROSS_OVL, HOP_CROSS_SEQ = range(4)


@dataclass(frozen=True)
class HierPlan:
    """Executable hop plan of the two-level ``("pod", "ring")`` messaging
    ring: P pods of R shards each, flat device index ``d = q * R + i``.

    Row-block packets shift one *intra-pod* hop per step (cheap,
    neighbor-local) and one *cross-pod* hop per intra-pod revolution (the
    pod-exchange cadence): after e pod hops and t intra hops, the packet at
    device (q, i) originated from block ``(q - e, i - t)``. ``epochs`` lists,
    per pod offset e, the intra offsets t this plan *processes* —
    ``((e, ((t, dedup), ...)), ...)`` — chosen so every unordered block pair
    is processed exactly once per iteration (property-tested in
    tests/test_schedule.py):

      * offset (e, t) meets its conjugate ``((P - e) % P, (R - t) % R)`` in
        flight simultaneously (both endpoints of the same unordered pair see
        each other), so the plan keeps the lexicographically smaller of the
        two — the flat ring's antipodal rule generalized to both levels;
      * self-conjugate offsets — (0, R/2), (P/2, 0) and (P/2, R/2) — deliver
        the pair to both endpoints at the SAME hop; ``dedup`` marks them and
        the lower flat-indexed device keeps the pair (:meth:`keep`), exactly
        ``dist.ring.process_pair``'s tie-break;
      * (0, 0) is the intra-block hop (own rows x own rows), handled by the
        ring bodies before the epoch walk.

    ``pods=1`` reproduces the flat ring schedule exactly: one epoch whose
    hops are ``process_pair``'s t = 1..R/2 with the antipodal dedup at R/2.
    """

    pods: int
    ring: int
    epochs: tuple

    @property
    def shards(self) -> int:
        return self.pods * self.ring

    @property
    def exchange_cadence(self) -> int:
        """Intra-pod hops between consecutive pod exchanges (one full
        intra-pod revolution: the epoch-entry packet IS the next epoch's
        packet, which is what lets the ring bodies issue the cross-pod
        ppermute a whole revolution of compute ahead)."""
        return self.ring

    def processed_offsets(self):
        """Flatten ``epochs`` to ``[(e, t, dedup), ...]`` in execution
        order (the intra-block (0, 0) hop excluded)."""
        return [(e, t, dd) for e, ts in self.epochs for t, dd in ts]

    def src(self, e: int, t: int, q, i):
        """Flat index of the block visiting device (q, i) at offset (e, t).
        ``q``/``i`` may be python ints (schedule tests) or traced device
        indices (the executed ring bodies)."""
        return ((q - e) % self.pods) * self.ring + (i - t) % self.ring

    def keep(self, dedup: bool, dst, src):
        """Whether ``dst`` processes the pair against ``src`` at a processed
        hop: always, except at self-conjugate (dedup) offsets where the
        lower flat-indexed endpoint keeps it."""
        return dst < src if dedup else True

    def hop_counts(self) -> dict:
        """Analytic per-iteration wire model, as a dict of ppermute-round
        counts: ``intra``/``cross`` split into ``*_ovl`` (overlapped:
        prefetched block packets + epoch-start pod exchanges) and ``*_seq``
        (sequential: the credit/done riders), plus the derived ``seq``
        critical-path total and ``overlap_frac``. Mirrors the exact walk the
        ring bodies execute, so the device-measured counters they emit are
        asserted equal to this model (tests/test_hier_ring.py) — the wire
        model in EXPERIMENTS.md is validated by the same run that proves
        order parity."""
        c = [0, 0, 0, 0]
        prev = None
        for eidx, (e, ts) in enumerate(self.epochs):
            if eidx + 1 < len(self.epochs):  # pod exchange for next epoch,
                c[HOP_CROSS_OVL] += 1        # issued at this epoch's start
            pos = 0
            for j, (t, _) in enumerate(ts):
                if pos != t:  # advance the packet to this hop's offset
                    c[HOP_INTRA_OVL] += 1
                if j + 1 < len(ts):  # prefetch the next hop's packet —
                    c[HOP_INTRA_OVL] += 1  # it lands at offset t + 1
                    pos = t + 1
                if prev is not None:  # riders catch up to this hop
                    if (t - prev[1]) % self.ring:
                        c[HOP_INTRA_SEQ] += 1
                    if (e - prev[0]) % self.pods:
                        c[HOP_CROSS_SEQ] += 1
                prev = (e, t)
        if prev is not None:  # riders ride home to their origin block
            if (-prev[1]) % self.ring:
                c[HOP_INTRA_SEQ] += 1
            if (-prev[0]) % self.pods:
                c[HOP_CROSS_SEQ] += 1
        total = sum(c)
        ovl = c[HOP_INTRA_OVL] + c[HOP_CROSS_OVL]
        return {
            "intra_ovl": c[HOP_INTRA_OVL], "intra_seq": c[HOP_INTRA_SEQ],
            "cross_ovl": c[HOP_CROSS_OVL], "cross_seq": c[HOP_CROSS_SEQ],
            "seq": c[HOP_INTRA_SEQ] + c[HOP_CROSS_SEQ],
            "total": total,
            "overlap_frac": ovl / total if total else 0.0,
        }


def make_hier_plan(pods: int, ring: int) -> HierPlan:
    """Build the two-level hop plan for P pods of R intra-pod shards.

    An offset (e, t) — e pod hops, t intra hops, (0, 0) excluded — is
    processed iff it is lexicographically <= its conjugate
    ``((P - e) % P, (R - t) % R)``; equality marks the self-conjugate
    (dedup) hops. Epochs run e = 0..P/2 (every unordered pod offset pair
    has met by the antipodal pod offset), each listing its processed intra
    offsets in ascending order — the order the ring bodies walk."""
    if pods < 1 or pods & (pods - 1):
        raise ValueError(f"pod count must be a power of two, got {pods}")
    if ring < 1 or ring & (ring - 1):
        raise ValueError(f"ring size must be a power of two, got {ring}")
    epochs = []
    for e in range(pods // 2 + 1):
        ts = []
        for t in range(ring):
            if e == 0 and t == 0:
                continue  # the intra-block hop, not a pair hop
            conj = ((pods - e) % pods, (ring - t) % ring)
            if (e, t) > conj:
                continue  # the conjugate offset processes this pair
            ts.append((t, (e, t) == conj))
        epochs.append((e, tuple(ts)))
    return HierPlan(pods=pods, ring=ring, epochs=tuple(epochs))

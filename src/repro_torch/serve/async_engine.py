"""Async LiNGAM serving engine: continuous batching for multi-tenant
causal-discovery traffic, on the card.

``LingamEngine`` (the sync front door) is submit-then-synchronous-``flush``:
one caller, one thread, dispatches block the queue. ``AsyncLingamEngine``
puts the same pack -> ``fit_batch`` -> unpad bucket dispatch
(``lingam_engine.dispatch_bucket``) behind the continuous-batching core
(``serve.batching``): any number of submitter threads enqueue concurrently
and immediately get a ``Ticket``; dispatcher threads flush each pow-2
``(p, n)`` bucket when it fills (``max_batch``) or when its oldest request
has waited ``flush_interval`` — the occupancy-vs-latency knob — with
per-request deadlines/priorities, bounded-queue backpressure (block or
shed), bounded failed-dispatch retry, per-bucket circuit breakers, and a
stats surface (queue depth, batch occupancy, padding waste, shed/retry/
quarantine counters, per-bucket p50/p95 latency). See ``serve/batching.py``
for the request lifecycle diagram and the delivery guarantees (an admitted
request is never silently dropped).

Fault-tolerance layers:

* ``replicas > 1`` (or an explicit ``pool_cfg``) drains the one admission
  queue with a **replicated dispatcher pool** (``serve/replica.py``): per-
  replica health states, a hung-dispatch watchdog with a hard wall-clock
  budget, and failover re-queue — a crashed or wedged replica's batch moves
  to a healthy peer instead of stranding its callers.
* ``prewarm=[(p, n), ...]`` **warms up** the listed bucket shapes at
  construction (``paralingam.aot_fit_batch``: the kernel library's build
  and load, the device context and the math libraries' handles, through one
  fit of one dataset per bucket; none of it depends on the batch count), so
  a fresh bucket's first request pays no cold start (which otherwise reads
  as a latency spike — or, under breakers and deadlines, as a sick bucket).
* ``serve_cfg.validate`` (default on) runs the ``core.validate`` admission
  guardrails at ``submit``: NaN/Inf cells, constant/duplicate variables and
  p > n rank deficiency are rejected with a typed ``DatasetError`` before
  any queueing or device work (counted in ``stats()["invalid_datasets"]``).

Determinism contract: a request's result is a deterministic function of the
batch it was packed into — replaying that batch through ``fit_batch`` gives
the same bits (the score kernel has no atomics and chooses its thread layout
per dataset, never from the batch size). Arrival order, replica failover and
pre-warming change only latency. Packing into another batch changes the
float32 rounding of the batched torch ops, so on the CPU a request returns
the causal order of a dedicated ``fit`` (asserted in
tests/test_torch_serve.py), and on the card it does so wherever the data is
not float32-ill-conditioned (``chip_smoke.py`` prints how many).

Sharded over the data ranks (``rules=make_rules(cfg, mesh)``): the
reference runs one controller over the whole mesh; here one process per rank
does, so one rank leads. Every rank of the mesh builds the engine with the
same arguments (a collective: each pre-warms, and they open a gloo group of
their own for the leader's messages). Rank 0 of the mesh is the leader: it
alone accepts ``submit`` and runs the batcher, the replicas and the stats.
Each device dispatch on the leader broadcasts a small header (the bucket, the
request count, the padded batch count, whether the seams are exact), then
sends the packed bucket (each data rank its block where the data ranks
divide the padded batch, the whole bucket to every rank where they do not),
and every rank then fits its rows and gathers the results (``fit_batch
(rules=)``'s path). Between the fit and the gather the ranks exchange
whether their fit raised: where one did, every rank raises ``FitFailed``
instead of entering the gather, the leader fails (or retries) the batch, and
the ranks stay in step. Every other rank runs a follower thread that does
the same until the leader's ``close()`` sends a stop header; ``close()`` on
a follower waits for it. The leader's dispatches reach the group one at a
time (one lock around header, fit and gather), whichever replica thread
runs them, so the followers see them in the order of their headers; the
replica pool takes that lock before its watchdog arms, so a dispatch's
budget does not count its wait for another's. A collective that fails (a
rank lost) closes the link on the rank that saw it: its connections close,
the other ranks' collectives on it fail at once, the followers end, and the
leader fails every later dispatch with ``EngineClosed``. The injected
``dispatch`` seams never reach the followers.

Everything timing- or failure-related is injectable: ``clock`` (a
``utils.clock.Clock``) and ``dispatch`` (the bucket-level device call — one
callable shared by all replicas, or a list of one per replica) seam the
engine for deterministic fake-clock and fault-injection tests — and for
``start=False`` + ``step()``/``run_once()`` manual pumping with zero
threads involved.
"""

from __future__ import annotations

import threading
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.paralingam import (
    BatchFitResult,
    ParaLiNGAMConfig,
    _device,
    _fit_local,
    aot_fit_batch,
    dispatch_stats_snapshot,
    numpy_dtype,
)
from repro_torch.dist.sharding import gather_rows, pack_rows, row_block, row_bytes, unpack_rows
from repro_torch.serve.batching import (
    BatchingConfig,
    BatchingCore,
    DispatchFailed,
    EngineClosed,
    Ticket,
)
from repro_torch.serve.lingam_engine import (
    LingamFit,
    LingamServeConfig,
    batch_pad,
    bucket_shape,
    check_dataset,
    check_engine_config,
    dispatch_bucket,
    host_results,
    pack_bucket,
    unpad,
)
from repro_torch.serve.replica import DEAD, ReplicaCrashed, ReplicaPool, ReplicaPoolConfig

#: Kinds of the leader's headers: int64 ``[kind, p_pad, n_pad, b, b_pad, exact]``.
STOP, DISPATCH, PREWARM = 0, 1, 2
#: How long a follower waits for the leader's next header: an engine may
#: sit idle between requests for as long as it serves (a dead leader closes
#: its connections, which ends the wait at once).
IDLE_TIMEOUT = timedelta(days=7)


class FitFailed(RuntimeError):
    """A sharded dispatch's fit raised on some rank; every rank of the mesh
    raises it, so none waits in the gather of the results."""


class MeshLink:
    """The leader's channel to the other ranks of a sharded engine's mesh:
    a gloo group of the mesh's ranks (host tensors, whatever the mesh's own
    backend), the leader (the mesh's rank 0), each rank's block index over
    the batch dimensions, the dtype of the packed buckets (the estimator's),
    and the lock that makes each of the leader's messages and the
    collectives of its dispatch one unit (reentrant: the replica pool's gate
    holds it around a dispatch that takes it again). Building it is a
    collective of the mesh's ranks."""

    def __init__(self, rules, dtype):
        ranks = [int(r) for r in rules.mesh.mesh.flatten().tolist()]
        self.rules = rules
        self.dtype = dtype
        self.leader = ranks[0]
        self.is_leader = dist.get_rank() == self.leader
        self.ranks = sorted(ranks)  # the group's ranks, by their rank in it
        self.group = dist.new_group(self.ranks, timeout=IDLE_TIMEOUT, backend="gloo",
                                    use_local_synchronization=True)
        self.blocks = [None] * len(ranks)  # each rank's block, by its rank in the group
        dist.all_gather_object(self.blocks, row_block(rules.batch_shards, rules)[1],
                               group=self.group)
        self.lock = threading.RLock()
        self.closed = False

    def abandon(self) -> None:
        """Close the link after a failed collective: destroy its group, whose
        connections close once the last reference goes (the caller holds no
        exception that still references the group), so the other ranks'
        collectives on it fail at once instead of waiting."""
        self.closed = True
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None

    def header(self, kind: int = STOP, p_pad: int = 0, n_pad: int = 0, b: int = 0,
               b_pad: int = 0, exact: bool = False) -> list[int]:
        """Broadcast the leader's header (the leader passes its fields) and
        return it on every rank."""
        head = torch.tensor([kind, p_pad, n_pad, b, b_pad, int(exact)], dtype=torch.int64)
        dist.broadcast(head, self.leader, group=self.group)
        return head.tolist()

    def bucket(self, head: list[int], packed=None):
        """Send the leader's packed bucket (``pack_bucket``'s ``xs``,
        ``mask``, ``n_valid``; the leader passes them) and return this rank's
        rows of them with the rules they run under (``row_block``'s): each
        rank its block (``dist.scatter``) where the batch ranks divide
        ``b_pad``, every row to every rank (``dist.broadcast``) where they do
        not."""
        _, p_pad, n_pad, _, b_pad, _ = head
        layout = [(self.dtype, (p_pad, n_pad)), (torch.bool, (p_pad,)), (torch.int32, ())]
        rules, lo, hi = row_block(b_pad, self.rules)
        buf = torch.empty((hi - lo, sum(row_bytes(*entry) for entry in layout)),
                          dtype=torch.uint8)
        rows = None if packed is None else pack_rows([torch.from_numpy(a) for a in packed])
        if rules.batch_shards > 1:
            k = hi - lo
            parts = None if rows is None else [rows[i * k:(i + 1) * k] for i in self.blocks]
            dist.scatter(buf, parts, src=self.leader, group=self.group)
        else:
            buf = rows if rows is not None else buf
            dist.broadcast(buf, self.leader, group=self.group)
        return unpack_rows(buf, layout), rules

    def agree(self, error: BaseException | None) -> None:
        """After each rank's fit, before the gather: every rank's error
        (``repr``, or None) on every rank; raise ``FitFailed`` on every rank
        where any rank's fit raised."""
        errors = [None] * len(self.ranks)
        dist.all_gather_object(errors, None if error is None else repr(error), group=self.group)
        failed = {rank: e for rank, e in zip(self.ranks, errors) if e is not None}
        if failed:
            raise FitFailed(f"the sharded fit raised on rank(s) {failed}")


class ServingPool(ReplicaPool):
    """The engine's replica pool: ``serve.replica.ReplicaPool`` with one rule
    more, so that no ticket is stranded.

    ``ReplicaPool`` fails its queue (``_fail_pool``) only once every replica
    is ``DEAD``. A replica wedged in a hung dispatch is not: the watchdog
    requeues its batch, but its thread stays blocked in the call, and when
    every other replica has crashed no thread takes the queue again. Here,
    whenever no replica can take work (each one is ``DEAD``, or blocked in a
    dispatch whose budget the watchdog has expired), the pool fails every
    queued request, the requeued ones included, with a typed
    ``DispatchFailed`` and shuts intake, as ``_fail_pool`` does. It checks
    after each watchdog expiry and after each replica crash. A wedged
    replica whose call returns later goes on through its state machine,
    and its late result is a zombie. Without a watchdog
    (``dispatch_budget=None``) no dispatch counts as wedged."""

    def __init__(self, *args, **kwargs):
        self._calls: dict[int, int] = {}  # watchdog token -> replica of the call
        self._stuck = False
        super().__init__(*args, **kwargs)

    def arm_dispatch(self, replica, bucket, reqs) -> int | None:
        token = super().arm_dispatch(replica, bucket, reqs)
        if token is not None:
            with self._wmu:
                self._calls[token] = replica.idx
        return token

    def disarm_dispatch(self, token: int | None) -> bool:
        if token is None:
            return True
        with self._wmu:
            self._calls.pop(token, None)
            return self._armed.pop(token, None) is not None

    def expire_hung(self) -> int:
        expired = super().expire_hung()
        if expired:
            self._fail_if_stuck(None)
        return expired

    def _dispatch_one(self, rep, bucket, reqs) -> None:
        try:
            super()._dispatch_one(rep, bucket, reqs)
        except ReplicaCrashed as e:
            self._fail_if_stuck(e)
            raise

    def _fail_if_stuck(self, cause: BaseException | None) -> None:
        """Fail the queue when no replica can take work, unless every
        replica is ``DEAD`` (``ReplicaPool._fail_pool`` has done it)."""
        with self._wmu:
            wedged = {idx for token, idx in self._calls.items() if token not in self._armed}
        core = self.core
        with core._mu:
            states = [r.state for r in self.replicas]
            if (self._stuck or all(s == DEAD for s in states)
                    or any(s != DEAD and r.idx not in wedged
                           for r, s in zip(self.replicas, states))):
                return
            self._stuck = True
            why = (f"{core.name}: no replica can take work (dead: "
                   f"{[r.idx for r in self.replicas if r.state == DEAD]}, wedged in an "
                   f"expired dispatch: {sorted(wedged)})")
            core._closed = True
            core._draining = False
            now = core.clock.now()
            for queued in core._queue.values():
                for r in queued:
                    err = DispatchFailed(why if cause is None else f"{why}: {cause!r}")
                    err.__cause__ = cause
                    core._finish_locked(r, kind="failed", now=now, error=err)
            core._queue.clear()
            core._depth = 0
            core._work.notify_all()
            core._space.notify_all()
            core._maybe_idle_locked()


class _GatedPool(ServingPool):
    """A replica pool whose dispatches run one at a time under ``gate`` (a
    sharded leader's link lock), taken before the watchdog arms: a
    dispatch's budget counts its own run, not its wait behind another
    replica's. A replica waiting at the gate counts as able to take work."""

    def __init__(self, *args, gate, **kwargs):
        self._gate = gate
        super().__init__(*args, **kwargs)

    def _dispatch_one(self, rep, bucket, reqs) -> None:
        with self._gate:
            super()._dispatch_one(rep, bucket, reqs)


class AsyncLingamEngine:
    """Thread-safe continuously-batching LiNGAM front door.

    ``submit`` returns a :class:`~repro_torch.serve.batching.Ticket` whose
    ``result()`` blocks for the request's :class:`LingamFit` (or raises its
    typed ``ServeError``); ``fit``/``fit_many`` are the blocking
    conveniences. Close with ``close()`` (or use as a context manager) to
    drain and stop the dispatcher thread(s).

    ``dispatch`` (signature ``dispatch(bucket, payloads) -> list[LingamFit]``)
    defaults to the real device path and is the fault-injection seam; pass a
    list of callables for per-replica seams. ``start=False`` skips the
    background threads so tests pump the engine manually via ``step()`` (or
    ``pool.run_once()`` with replicas) under a ``FakeClock``. ``device`` as
    in ``fit``: ``None`` means ``cuda`` and raises at construction without a
    card; ``"cpu"`` runs the plain torch path.

    ``rules`` (``make_rules(cfg, mesh)``) shards every dispatch over the
    mesh's data ranks, with the leader and followers of the module
    docstring: every rank of the mesh constructs the engine with the same
    arguments, the leader (the mesh's rank 0) serves, and the followers'
    ``close()`` returns once the leader's has.
    """

    def __init__(self, config: ParaLiNGAMConfig | None = None,
                 serve_cfg: LingamServeConfig | None = None, rules=None, *,
                 batch_cfg: BatchingConfig | None = None, clock=None,
                 dispatch=None, start: bool = True,
                 replicas: int = 1, pool_cfg: ReplicaPoolConfig | None = None,
                 prewarm=None, device=None):
        self.config = check_engine_config(config)
        self.serve_cfg = serve_cfg or LingamServeConfig()
        self.rules = rules
        self.device = _device(device, "AsyncLingamEngine")
        batch_cfg = batch_cfg or BatchingConfig(
            max_batch=self.serve_cfg.max_batch)
        if batch_cfg.max_batch > self.serve_cfg.max_batch:
            raise ValueError(
                f"batch_cfg.max_batch={batch_cfg.max_batch} exceeds "
                f"serve_cfg.max_batch={self.serve_cfg.max_batch} (the "
                "dispatch-side batch bound)")
        self._warmed: set = set()  # (p_pad, n_pad) buckets warmed up
        self.prewarm_stats = {"buckets": 0, "executables": 0, "compile_seconds": 0.0}
        self._invalid = 0
        self._inv_mu = threading.Lock()
        self._follower: threading.Thread | None = None
        self._follower_error: BaseException | None = None
        self._built = False  # prewarm runs on every rank until construction ends
        self.link: MeshLink | None = None
        if rules is not None and rules.mesh is not None and rules.mesh.size() > 1:
            self.link = MeshLink(rules, self.config.dtype)
        if prewarm:
            self.prewarm(prewarm)

        seams = dispatch if isinstance(dispatch, (list, tuple)) else None
        if seams is not None:
            if pool_cfg is None:
                pool_cfg = ReplicaPoolConfig(replicas=len(seams))
            elif pool_cfg.replicas != len(seams):
                raise ValueError(
                    f"{len(seams)} dispatch seams for "
                    f"{pool_cfg.replicas} replicas")
            first = seams[0]
        else:
            first = dispatch or self._device_dispatch
        self._dispatch_seam = first
        self.core = BatchingCore(self._dispatch_checked, batch_cfg,
                                 clock=clock, name="lingam-async")
        self.pool: ReplicaPool | None = None
        if self.link is not None and not self.link.is_leader:
            self._follower = threading.Thread(target=self._follow, name="lingam-follower",
                                              daemon=True)
            self._follower.start()
        elif replicas > 1 or pool_cfg is not None or seams is not None:
            pcfg = pool_cfg or ReplicaPoolConfig(replicas=replicas)
            checked = None
            if seams is not None:
                checked = [self._make_checked(s) for s in seams]
            if self.link is None:
                self.pool = ServingPool(self.core, pcfg, checked, start=start)
            else:
                self.pool = _GatedPool(self.core, pcfg, checked, start=start,
                                       gate=self.link.lock)
        elif start:
            self.core.start()
        self._built = True

    # -- pre-warm -----------------------------------------------------------

    def prewarm(self, shapes) -> dict:
        """Warm up the buckets the given request ``(p, n)`` shapes land on.
        Without ``rules``: one ``aot_fit_batch`` of one dataset per bucket
        (the build, module loads and library handles it pays are the same
        for every batch count). With ``rules``: the batch counts the
        reference warms (every power of two up to ``max_batch`` with
        ``pad_batch_pow2``, else ``max_batch``), each ``aot_fit_batch(rules=)``
        on every rank (each count cuts the batch over the data ranks its own
        way). After construction only the
        leader calls it, and its followers warm what its header names.
        Returns ``prewarm_stats``."""
        if self._follower is not None:
            raise ValueError("a follower warms up what the leader's prewarm sends")
        for p_pad, n_pad in sorted({bucket_shape(p, n, self.serve_cfg)
                                    for p, n in shapes} - self._warmed):
            if self._built and self.link is not None:
                self._lead(lambda: (self.link.header(PREWARM, p_pad, n_pad),
                                    self._warm(p_pad, n_pad)))
            else:
                self._warm(p_pad, n_pad)
        return dict(self.prewarm_stats)

    def _warm(self, p_pad: int, n_pad: int) -> None:
        scfg = self.serve_cfg
        counts = [1]
        if self.rules is not None:
            counts = [scfg.max_batch]
            if scfg.pad_batch_pow2:
                counts = sorted({min(1 << i, scfg.max_batch)
                                 for i in range(scfg.max_batch.bit_length())})
        for b_pad in counts:
            exe = aot_fit_batch(b_pad, p_pad, n_pad, self.config, padded=True,
                                rules=self.rules, device=self.device)
            self.prewarm_stats["executables"] += 1
            self.prewarm_stats["compile_seconds"] += exe.compile_seconds
        self._warmed.add((p_pad, n_pad))
        self.prewarm_stats["buckets"] = len(self._warmed)

    # -- dispatch seam ------------------------------------------------------

    def _device_dispatch(self, bucket, payloads) -> list[LingamFit]:
        """Default dispatch: the shared pack -> fit_batch -> unpad path; on a
        sharded engine's leader, the header and the bucket to the followers
        first, then this rank's rows through the same fit."""
        p_pad, n_pad = bucket
        if self.link is None:
            return dispatch_bucket(payloads, p_pad, n_pad, self.config, self.serve_cfg,
                                   self.rules, device=self.device)
        b_pad = batch_pad(len(payloads), self.serve_cfg, self.rules)
        xs, mask, n_valid, exact = pack_bucket(payloads, p_pad, n_pad, b_pad,
                                               numpy_dtype(self.config.dtype))
        return unpad(payloads, self._lead(lambda: self._mesh_rows(
            self.link.header(DISPATCH, p_pad, n_pad, len(payloads), b_pad, exact),
            (xs, mask, n_valid))))

    def _lead(self, send):
        """Run the leader's ``send`` (a header and what follows it) under the
        link's lock and return what it returns. ``FitFailed`` leaves the
        ranks in step and is raised as it is; any other error closes the
        link (``MeshLink.abandon``) and raises ``EngineClosed``, as does
        every later call."""
        with self.link.lock:
            if self.link.closed:
                raise EngineClosed("the sharded engine's link to its followers is closed")
            try:
                return send()
            except FitFailed:
                raise
            except Exception as e:  # noqa: BLE001 — the link is lost: raised below
                cause = repr(e)
            self.link.abandon()  # outside the handler: no traceback holds the group
        raise EngineClosed(f"the sharded engine's link to its followers failed: {cause}")

    def _mesh_rows(self, head: list[int], packed=None):
        """This rank's rows of the header's bucket, received from the leader
        (which passes the ``packed`` bucket), through the batched fit (one
        copy to the device), the ranks' agreement that every fit ran
        (``MeshLink.agree``) and the gather: every row's host results."""
        (xs, mask, n_valid), rules = self.link.bucket(head, packed)
        seams = {} if head[5] else dict(n_valid=n_valid, mask=mask)
        rows, error = None, None
        try:
            rows = _fit_local(xs, self.config, self.device, **seams)
        except Exception as e:  # noqa: BLE001 — every rank raises it in agree()
            error = e
        self.link.agree(error)
        return host_results(BatchFitResult(*gather_rows(rows, rules)))

    def _follow(self) -> None:
        """A follower's loop: run each dispatch and warm-up that the
        leader's headers name, until its stop header. A fit that raised on
        some rank (``FitFailed``) is the leader's to report; any other
        error ends the loop, closes the link and is raised again by
        ``close()``."""
        try:
            while True:
                head = self.link.header()
                if head[0] == STOP:
                    return
                try:
                    if head[0] == PREWARM:
                        self._warm(head[1], head[2])
                    else:
                        self._mesh_rows(head)
                except FitFailed:
                    continue
        except Exception as e:  # noqa: BLE001 — raised again by close()
            self._follower_error = e.with_traceback(None)
        self.link.abandon()  # outside the handler: no traceback holds the group

    def _dispatch_checked(self, bucket, payloads):
        return self._checked(self._dispatch_seam, bucket, payloads)

    def _make_checked(self, seam):
        return lambda bucket, payloads: self._checked(seam, bucket, payloads)

    def _checked(self, seam, bucket, payloads):
        """Run the (injectable) dispatch seam, then validate each result:
        non-finite fits — a NaN'd Cholesky, a poisoned batch neighbour — are
        converted to per-request ``DispatchFailed`` rejections so the core
        retries or fails *that* request instead of delivering corrupt output.
        Also accounts the bucket's padding waste (pow-2 shape padding cells
        and batch-count padding cells vs live data cells)."""
        p_pad, n_pad = bucket
        results = seam(bucket, payloads)
        if results is not None and len(results) == len(payloads):
            live = sum(int(np.prod(x.shape)) for x in payloads)
            total = batch_pad(len(payloads), self.serve_cfg, self.rules) * p_pad * n_pad
            self.core.note_bucket(bucket, pad_cells=total - live,
                                  total_cells=total)
            results = [
                r if isinstance(r, BaseException) or _fit_finite(r)
                else DispatchFailed(
                    f"non-finite fit result for request in bucket {bucket}")
                for r in results
            ]
        return results

    # -- intake -------------------------------------------------------------

    def submit(self, x, *, priority: int = 0, deadline: float | None = None,
               overflow: str | None = None) -> Ticket:
        """Enqueue one (p, n) dataset. ``deadline`` is relative seconds on
        the engine clock: the bucket flushes early enough to honor it, and a
        request still queued past it is failed with ``RequestTimeout``
        (work already on the device is delivered, not cancelled). Higher
        ``priority`` wins within a bucket. ``overflow`` ("block"/"shed")
        overrides the configured backpressure policy for this request.
        With ``serve_cfg.validate`` a degenerate dataset raises a typed
        ``DatasetError`` here, before any queueing. A sharded engine's
        follower refuses it: the leader (the mesh's rank 0) takes every
        request."""
        if self._follower is not None:
            raise ValueError(
                f"rank {dist.get_rank()} follows the sharded engine's leader: submit on "
                f"rank {self.link.leader} (the mesh's rank 0)")
        try:
            x = check_dataset(x, validate=self.serve_cfg.validate)
        except ValueError:
            with self._inv_mu:
                self._invalid += 1
            raise
        bucket = bucket_shape(*x.shape, self.serve_cfg)
        return self.core.submit(x, bucket, priority=priority,
                                deadline=deadline, overflow=overflow)

    def fit(self, x, *, priority: int = 0, deadline: float | None = None,
            timeout: float | None = None) -> LingamFit:
        """Blocking submit + result."""
        return self.submit(x, priority=priority, deadline=deadline).result(timeout)

    def fit_many(self, xs, *, timeout: float | None = None) -> list[LingamFit]:
        tickets = [self.submit(x) for x in xs]
        return [t.result(timeout) for t in tickets]

    # -- control / observability -------------------------------------------

    def step(self) -> int:
        """Manual scheduling pass (``start=False`` engines / tests). Returns
        the number of batches dispatched. With a replica pool, prefer
        ``pool.run_once()`` so replica health is exercised too."""
        return self.core.step()

    def join(self, timeout: float | None = None) -> bool:
        return self.core.join(timeout)

    @property
    def pending(self) -> int:
        return self.core.pending

    def stats(self) -> dict:
        """Core stats snapshot plus the estimator-level counters threaded up
        from ``core.paralingam``, the admission guardrail rejections,
        pre-warm totals, and — with a replica pool — per-replica health and
        watchdog counters.

        ``kernel_bypass`` is the requested-kernel-but-ran-plain-torch
        tripwire: every backend serves the padded batched route, so it must
        read 0 (asserted by the engine tests). ``auto_downgrade`` counts
        dispatches where ``score_backend="auto"`` resolved to a plain torch
        formulation (any device but the card)."""
        out = self.core.snapshot()
        est = dispatch_stats_snapshot()
        out["kernel_bypass"] = est["kernel_bypass"]
        out["auto_downgrade"] = est["auto_downgrade"]
        with self._inv_mu:
            out["invalid_datasets"] = self._invalid
        out["prewarm"] = dict(self.prewarm_stats)
        if self.pool is not None:
            out["pool"] = self.pool.snapshot()
        return out

    def close(self, *, drain: bool = True, timeout: float | None = None) -> None:
        """Drain (or not) and stop the dispatcher thread(s). On a sharded
        engine's leader, then send the followers' stop header; on a
        follower, wait for it (up to ``timeout``) and raise what ended its
        loop, if anything did."""
        if self._follower is not None:
            self._follower.join(timeout)
            if self._follower.is_alive():
                raise TimeoutError(f"no stop header from the leader in {timeout} s")
            if self._follower_error is not None:
                raise self._follower_error
            return
        if self.pool is not None:
            self.pool.close(drain=drain, timeout=timeout)
        else:
            self.core.close(drain=drain, timeout=timeout)
        if self.link is not None:
            with self.link.lock:
                if not self.link.closed:
                    self.link.closed = True
                    self.link.header(STOP)

    def __enter__(self) -> "AsyncLingamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fit_finite(f: LingamFit) -> bool:
    return bool(np.isfinite(f.b).all() and np.isfinite(f.noise_var).all())

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

Everything timing- or failure-related is injectable: ``clock`` (a
``utils.clock.Clock``) and ``dispatch`` (the bucket-level device call — one
callable shared by all replicas, or a list of one per replica) seam the
engine for deterministic fake-clock and fault-injection tests — and for
``start=False`` + ``step()``/``run_once()`` manual pumping with zero
threads involved.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.paralingam import (
    ParaLiNGAMConfig,
    _device,
    aot_fit_batch,
    dispatch_stats_snapshot,
)
from repro_torch.serve.batching import (
    BatchingConfig,
    BatchingCore,
    DispatchFailed,
    Ticket,
)
from repro_torch.serve.lingam_engine import (
    LingamFit,
    LingamServeConfig,
    bucket_shape,
    check_dataset,
    check_engine_config,
    dispatch_bucket,
)
from repro_torch.serve.replica import ReplicaPool, ReplicaPoolConfig


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
    """

    def __init__(self, config: ParaLiNGAMConfig | None = None,
                 serve_cfg: LingamServeConfig | None = None, *,
                 batch_cfg: BatchingConfig | None = None, clock=None,
                 dispatch=None, start: bool = True,
                 replicas: int = 1, pool_cfg: ReplicaPoolConfig | None = None,
                 prewarm=None, device=None):
        self.config = check_engine_config(config)
        self.serve_cfg = serve_cfg or LingamServeConfig()
        self.device = _device(device, "AsyncLingamEngine")
        batch_cfg = batch_cfg or BatchingConfig(
            max_batch=self.serve_cfg.max_batch)
        if batch_cfg.max_batch > self.serve_cfg.max_batch:
            raise ValueError(
                f"batch_cfg.max_batch={batch_cfg.max_batch} exceeds "
                f"serve_cfg.max_batch={self.serve_cfg.max_batch} (the "
                "dispatch-side batch bound)")
        self._warmed: set = set()  # (p_pad, n_pad) buckets warmed up
        self.prewarm_stats = {"buckets": 0, "compile_seconds": 0.0}
        self._invalid = 0
        self._inv_mu = threading.Lock()
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
        if replicas > 1 or pool_cfg is not None or seams is not None:
            pcfg = pool_cfg or ReplicaPoolConfig(replicas=replicas)
            checked = None
            if seams is not None:
                checked = [self._make_checked(s) for s in seams]
            self.pool = ReplicaPool(self.core, pcfg, checked, start=start)
        elif start:
            self.core.start()

    # -- pre-warm -----------------------------------------------------------

    def prewarm(self, shapes) -> dict:
        """Warm up the buckets the given request ``(p, n)`` shapes land on,
        with one ``aot_fit_batch`` of one dataset per bucket: the build,
        module loads and library handles it pays are the same for every
        batch count. Returns ``prewarm_stats``."""
        for p_pad, n_pad in sorted({bucket_shape(p, n, self.serve_cfg)
                                    for p, n in shapes} - self._warmed):
            exe = aot_fit_batch(1, p_pad, n_pad, self.config, device=self.device)
            self._warmed.add((p_pad, n_pad))
            self.prewarm_stats["compile_seconds"] += exe.compile_seconds
        self.prewarm_stats["buckets"] = len(self._warmed)
        return dict(self.prewarm_stats)

    # -- dispatch seam ------------------------------------------------------

    def _device_dispatch(self, bucket, payloads) -> list[LingamFit]:
        """Default dispatch: the shared pack -> fit_batch -> unpad path."""
        p_pad, n_pad = bucket
        return dispatch_bucket(payloads, p_pad, n_pad, self.config,
                               device=self.device)

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
        vs live data cells)."""
        p_pad, n_pad = bucket
        results = seam(bucket, payloads)
        if results is not None and len(results) == len(payloads):
            live = sum(int(np.prod(x.shape)) for x in payloads)
            total = len(payloads) * p_pad * n_pad
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
        ``DatasetError`` here, before any queueing."""
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
        if self.pool is not None:
            self.pool.close(drain=drain, timeout=timeout)
        else:
            self.core.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "AsyncLingamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fit_finite(f: LingamFit) -> bool:
    return bool(np.isfinite(f.b).all() and np.isfinite(f.noise_var).all())

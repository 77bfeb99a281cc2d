"""LiNGAM serving engine: the front door for causal-discovery traffic, on
the card.

Requests (one observation matrix each, any shape) are queued, bucketed by
power-of-two padded ``(p, n)`` shape, stacked into batches, and dispatched
through the batched estimator (``paralingam.fit_batch``: normalize ->
covariance -> causal-order scan -> Cholesky adjacency over a leading dataset
axis). Results are unpadded back to each request's true shape before
delivery.

Why bucketing matters here: the estimator's cost on the card is dominated by
host work per find-root iteration (tens of small torch ops and one kernel
launch), whatever the data size. A bucket of B datasets pays that host cost
once per iteration instead of B times, and one launch of the batched score
kernel covers all B datasets.

Padding is exact, not approximate: dead variable rows ride a live mask
through the scan driver, padded sample columns ride ``n_valid`` through every
moment denominator (``pairwise.stream_moments``), so a padded request returns
the causal order of a dedicated unpadded ``fit`` up to float32 rounding of
its sums (asserted on the CPU in tests/test_torch_serve.py).

Each dispatch packs its requests into one host array in the estimator's
dtype (``ParaLiNGAMConfig.dtype``: float32 unless it says float64), copies it
to the device once, and reads every result back in one copy.

Batches can shard across ranks: pass ``rules=make_rules(cfg, mesh)`` (a
``"data"`` mesh dimension) and each dispatch fits this rank's block of the
bucket's datasets and gathers the results (``fit_batch(rules=)``). Where
the data ranks do not divide a bucket's request count, its batch count is
padded to a power of two (``pad_batch_pow2``), so a power-of-two data
dimension divides a partial bucket too. ``LingamEngine`` is then SPMD: every rank of the mesh submits the same datasets in the same
order and flushes alike; bucketing is deterministic, so every rank runs the
same dispatches and returns every result.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.paralingam import ParaLiNGAMConfig, _device, fit_batch, numpy_dtype
from repro_torch.core.validate import require_valid
from repro_torch.dist.sharding import pack_rows, unpack_rows
from repro_torch.serve.buckets import bucket_shape, pad_dataset  # noqa: F401
from repro_torch.utils.shapes import next_pow2


@dataclass(frozen=True)
class LingamServeConfig:
    max_batch: int = 64  # datasets per dispatch (a bucket splits into chunks)
    min_p_bucket: int = 8  # floors of the pow-2 padding grid: tiny requests
    min_n_bucket: int = 64  # share one bucket instead of one each
    pad_batch_pow2: bool = True  # pad a sharded dispatch's batch count up
    #   to a power of two (zero datasets, all-dead mask) where the data ranks
    #   do not divide it, as the reference does: a power-of-two data
    #   dimension then divides a partial bucket. One rank never pads (see
    #   ``batch_pad``).
    validate: bool = True  # run the core.validate admission guardrails on
    #   every submitted dataset (NaN/Inf cells, constant/duplicate variables,
    #   p > n rank deficiency) and reject with a typed DatasetError before
    #   the request ever occupies a batch slot or burns a retry.


@dataclass
class LingamFit:
    """One request's unpadded result."""

    order: list[int]
    b: np.ndarray  # (p, p) causal strengths
    noise_var: np.ndarray  # (p,) exogenous noise variances
    comparisons: int
    rounds: int
    converged: bool


@dataclass
class _Pending:
    req_id: int
    x: np.ndarray  # (p, n) raw observations


def check_engine_config(config: ParaLiNGAMConfig | None) -> ParaLiNGAMConfig:
    """Shared construction-time config validation of the sync and async
    engines: fail at construction, not at the first flush. ``fit_batch`` has
    no ring form (the batch axis shards via ``rules`` instead)."""
    config = config or ParaLiNGAMConfig()
    if config.order_backend == "ring":
        raise ValueError(
            "the LiNGAM engines dispatch through fit_batch, which has no "
            "ring form: use order_backend='host' or 'scan' and shard the "
            "batch axis via rules=make_rules(cfg, mesh)")
    return config


def check_dataset(x, *, validate: bool = False) -> np.ndarray:
    """Coerce one request payload to a float64 (p, n) matrix (shared request
    validation of the sync and async engines). ``validate=True`` additionally
    runs the :mod:`repro_torch.core.validate` admission guardrails, raising a
    typed ``DatasetError`` (a ``ValueError``) with full diagnostics on
    degenerate data — before any queueing or device work."""
    x = np.asarray(x, np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected one (p, n) dataset, got shape {x.shape}")
    if validate:
        require_valid(x)
    return x


def batch_pad(b: int, serve_cfg: LingamServeConfig, rules=None) -> int:
    """The batch count a bucket of ``b`` requests dispatches at under
    ``rules``: ``min(next_pow2(b), max_batch)`` with ``pad_batch_pow2`` where
    the rules' batch ranks are more than one and do not divide ``b``, else
    ``b``. The reference pads every bucket to bound the shapes XLA compiles;
    the port compiles nothing per shape, so only the data ranks need it."""
    shards = 1 if rules is None else rules.batch_shards
    if serve_cfg.pad_batch_pow2 and b % shards:
        return min(next_pow2(b), serve_cfg.max_batch)
    return b


def pack_bucket(xs_list: list[np.ndarray], p_pad: int, n_pad: int, b_pad: int | None = None,
                dtype=np.float32):
    """Zero-pad ragged datasets into one ``(b_pad, p_pad, n_pad)`` host batch
    of ``dtype`` (the estimator's: float32 or float64), one dataset per
    request and zero datasets with no live row after them (``b_pad``
    defaults to the request count). Returns ``(xs, mask, n_valid, exact)``:
    the live-row mask (b_pad, p_pad), the valid sample counts (b_pad,), and
    whether nothing was padded at all (then the seams can be left out).
    Each float64 request is rounded once, to ``dtype``: a float32 pack has
    the bits of the reference's float64 pack cast to float32."""
    b = len(xs_list)
    b_pad = b if b_pad is None else b_pad
    xs = np.zeros((b_pad, p_pad, n_pad), dtype)
    mask = np.zeros((b_pad, p_pad), bool)
    n_valid = np.full((b_pad,), n_pad, np.int32)
    exact = b == b_pad
    for i, x in enumerate(xs_list):
        p, n = x.shape
        xs[i, :p, :n] = x
        mask[i, :p] = True
        n_valid[i] = n
        exact &= (p == p_pad and n == n_pad)
    return xs, mask, n_valid, exact


def _read_back(*ts):
    """Numpy copies of device tensors with a common leading row count through
    ONE device-to-host copy: their rows packed into one byte buffer on the
    device (``dist.sharding.pack_rows``) and split again on the host."""
    host = pack_rows(ts).cpu()
    return [t.numpy() for t in unpack_rows(host, [(t.dtype, t.shape[1:]) for t in ts])]


def host_results(res):
    """A ``BatchFitResult``'s host ``(orders, comparisons, b, noise_var,
    rounds, converged)``, read back in one copy."""
    return _read_back(res.orders, res.comparisons, res.b, res.noise_var, res.rounds,
                      res.converged)


def unpad(xs_list: list[np.ndarray], results) -> list[LingamFit]:
    """Each request's ``LingamFit`` from a bucket's host results
    (``host_results``'), cut back to its true shape."""
    orders, comps, bs, omegas, rounds, conv = results
    out = []
    for i, x in enumerate(xs_list):
        p = x.shape[0]
        out.append(LingamFit(
            order=[int(v) for v in orders[i, :p]],
            b=bs[i, :p, :p],
            noise_var=omegas[i, :p],
            comparisons=int(comps[i, : max(p - 1, 0)].sum()),
            rounds=int(rounds[i, : max(p - 1, 0)].sum()),
            converged=bool(conv[i, : max(p - 1, 0)].all()),
        ))
    return out


def dispatch_bucket(xs_list: list[np.ndarray], p_pad: int, n_pad: int,
                    config: ParaLiNGAMConfig, serve_cfg: LingamServeConfig | None = None,
                    rules=None, compiled=None, *, device=None) -> list[LingamFit]:
    """One bucket's device dispatch, shared by the sync and async engines:
    pack the raw ragged datasets into a zero-padded (b_pad, p_pad, n_pad)
    host batch (the batch count padded as ``batch_pad`` says),
    run the batched fit (which copies this rank's rows of it to the device
    once), read the results back once, and unpad each back to its request's
    true shape.
    Returns one ``LingamFit`` per input dataset, in order.

    ``rules`` shards the batch over the mesh's data ranks
    (``fit_batch(rules=)``): a collective, which every rank of the mesh
    calls with the same datasets, each of them returning every fit.

    ``compiled`` (the reference's executables by bucket shape) is accepted
    and unused: the port compiles nothing per shape, and a warm-up
    (``paralingam.aot_fit_batch``) leaves nothing that a later call needs."""
    dev = _device(device, "dispatch_bucket")
    b_pad = batch_pad(len(xs_list), serve_cfg or LingamServeConfig(), rules)
    xs, mask, n_valid, exact = pack_bucket(xs_list, p_pad, n_pad, b_pad,
                                           numpy_dtype((config or ParaLiNGAMConfig()).dtype))
    seams = {} if exact else dict(n_valid=n_valid, mask=mask)
    return unpad(xs_list, host_results(fit_batch(xs, config, rules=rules, device=dev, **seams)))


class LingamEngine:
    """Queue -> bucket -> batched fit -> unpad. Single-host front door.

    ``submit`` enqueues and returns a request id; ``flush`` dispatches every
    pending bucket and returns ``{req_id: LingamFit}``. ``fit_many`` is the
    submit-all + flush convenience. ``stats`` counts requests, dispatches and
    per-bucket traffic. ``device`` as in ``fit``: ``None`` means ``cuda``
    and raises at construction without a card; ``"cpu"`` runs the plain
    torch path.

    ``rules`` (``make_rules(cfg, mesh)``) shards every dispatch over the
    mesh's data ranks. The engine is then SPMD: every rank of the mesh
    builds it alike and calls ``submit``/``flush``/``fit_many`` with the
    same datasets in the same order, and every rank gets every result."""

    def __init__(self, config: ParaLiNGAMConfig | None = None,
                 serve_cfg: LingamServeConfig | None = None, rules=None, *, device=None):
        self.config = check_engine_config(config)
        self.serve_cfg = serve_cfg or LingamServeConfig()
        self.rules = rules
        self.device = _device(device, "LingamEngine")
        self._queue: list[_Pending] = []
        self._completed: dict[int, LingamFit] = {}  # survives a failed flush
        self._next_id = 0
        self.stats: dict = {"requests": 0, "dispatches": 0, "buckets": {}}

    # -- intake -------------------------------------------------------------

    def submit(self, x) -> int:
        x = check_dataset(x, validate=self.serve_cfg.validate)
        req_id = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(req_id, x))
        self.stats["requests"] += 1
        key = bucket_shape(*x.shape, self.serve_cfg)
        self.stats["buckets"][key] = self.stats["buckets"].get(key, 0) + 1
        return req_id

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- dispatch -----------------------------------------------------------

    def flush(self) -> dict[int, LingamFit]:
        """Dispatch every pending bucket. No request's work is ever lost to a
        failing dispatch: each chunk's results are stashed on the engine as
        soon as its dispatch delivers and its requests leave the queue, so
        when a *later* chunk raises, the exception propagates with the
        failing + undispatched requests still queued and the finished
        results retained — a retry ``flush`` reruns only the remainder and
        returns everything."""
        scfg = self.serve_cfg
        buckets: dict[tuple[int, int], list[_Pending]] = {}
        for req in self._queue:
            buckets.setdefault(bucket_shape(*req.x.shape, scfg), []).append(req)

        for (p_pad, n_pad), reqs in sorted(buckets.items()):
            for lo in range(0, len(reqs), scfg.max_batch):
                chunk = reqs[lo: lo + scfg.max_batch]
                self._completed.update(self._dispatch(chunk, p_pad, n_pad))
                delivered = {req.req_id for req in chunk}
                self._queue = [r for r in self._queue
                               if r.req_id not in delivered]
        out, self._completed = self._completed, {}
        return out

    def fit_many(self, xs) -> list[LingamFit]:
        ids = [self.submit(x) for x in xs]
        results = self.flush()
        return [results[i] for i in ids]

    def _dispatch(self, reqs: list[_Pending], p_pad: int,
                  n_pad: int) -> dict[int, LingamFit]:
        fits = dispatch_bucket([req.x for req in reqs], p_pad, n_pad, self.config,
                               self.serve_cfg, self.rules, device=self.device)
        self.stats["dispatches"] += 1
        return {req.req_id: f for req, f in zip(reqs, fits)}

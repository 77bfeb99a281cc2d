"""ParaLiNGAM (Algorithms 3 and 9-10 of the paper) in PyTorch: the dense
estimator end to end on one device, for one dataset (``fit``) or a bucket of
datasets at once (``fit_batch``, what the serving engines call).

Both run the whole pipeline as device work with one host readback at the
end: normalize -> covariance -> the staged causal-order scan (p find-root ->
rank-1-update iterations on the power-of-two stage plan of
``utils/schedule``) -> phase-2 adjacency by Cholesky. Each find-root is the
one-shot dense evaluation with messaging folded in: every residual entropy
is computed once and both workers of a pair are credited (Section 3.1).

The driver works on a leading dataset axis throughout (``fit`` is a bucket
of one), so a bucket of B datasets costs one set of torch ops and one kernel
launch per find-root, not B. The rows still in U are compacted into
power-of-two buffers at the <= log2 p stage transitions, per dataset, with a
stable ``argsort`` of the dead-row mask (no ``nonzero``, which syncs to the
host); the per-iteration counters stay on the device until they are read.

Not in this module yet (``ConfigError`` names the ROADMAP item that brings
each): the threshold state machine (``threshold=True``), the messaging ring
(``order_backend="ring"``) and the host driver.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.adjacency import adjacency_from_order, complete_order
from repro_torch.core.covariance import cov_matrix, normalize, update_cov, update_data
from repro_torch.core.pairwise import (
    fused_scores,
    pair_stat_matrix,
    residual_entropy_matrix,
    row_entropies,
    scores_from_stats,
)
from repro_torch.kernels import ops as kops
from repro_torch.utils.schedule import make_schedule


class ConfigError(ValueError):
    """A ``ParaLiNGAMConfig`` combination is contradictory, unknown, or not
    ported yet."""


#: Order drivers the JAX package knows; ``host`` and ``scan`` both run the
#: device-resident scan in ``fit`` (as they do there).
ORDER_BACKENDS = ("host", "scan", "ring")

_NOT_PORTED = {
    "threshold": "threshold=True (the threshold state machine) is not ported "
                 "yet: ROADMAP.md queue 1 item 4",
    "ring": "order_backend='ring' (the messaging ring) is not ported yet: "
            "ROADMAP.md queue 1 item 8",
}


@dataclass(frozen=True)
class ParaLiNGAMConfig:
    order_backend: str = "host"  # "host" | "scan": both run the
    #   device-resident scan in ``fit``; "ring" is not ported yet
    score_backend: str = "auto"  # "torch" | "torch_fused" | "hopper_fused"
    #   | "auto" (``kernels.ops.SCORE_BACKENDS``); ``auto`` resolves to the
    #   fused CUDA kernel on the card and the square plain path on the CPU
    block_j: int = 32  # block of the torch_fused sweep (min(block_j, m))
    threshold: bool = False  # the threshold state machine (not ported yet)
    min_bucket: int = 32  # floor of the power-of-two stage buffers

    def __post_init__(self):
        if self.order_backend not in ORDER_BACKENDS:
            raise ConfigError(
                f"order_backend={self.order_backend!r} is not one of "
                f"{ORDER_BACKENDS}"
            )
        if self.order_backend == "ring":
            raise ConfigError(_NOT_PORTED["ring"])
        if self.threshold:
            raise ConfigError(_NOT_PORTED["threshold"])


#: The JAX package's score-backend names and their counterparts here.
_BACKEND_NAMES = {"xla": "torch", "xla_fused": "torch_fused",
                  "pallas": "hopper", "pallas_fused": "hopper_fused",
                  "auto": "auto"}


def _legacy_score_backend(d: dict) -> str:
    """``score_backend`` of a reference config dict, with the deprecated
    ``use_kernel``/``fused`` pair mapped as the JAX package maps it."""
    use_kernel, fused = d.get("use_kernel"), d.get("fused")
    backend = d.get("score_backend", "auto")
    if use_kernel is None and fused is None:
        return backend
    legacy = {(False, False): "xla", (False, True): "xla_fused",
              (True, False): "pallas", (True, True): "pallas_fused"}[
        (bool(use_kernel), bool(fused))]
    if backend not in ("auto", legacy):
        raise ConfigError(
            "pass either score_backend or the deprecated use_kernel/fused "
            f"flags, not both (got score_backend={backend!r}, "
            f"use_kernel={use_kernel}, fused={fused})"
        )
    return legacy


def _legacy_order(d: dict) -> tuple[str, bool]:
    """``(order_backend, threshold)`` of a reference config dict, with the
    deprecated ``method``/``ring`` pair mapped as the JAX package maps it."""
    method, ring = d.get("method"), d.get("ring")
    order_backend = d.get("order_backend", "host")
    threshold = bool(d.get("threshold", False))
    if method is None and ring is None:
        return order_backend, threshold
    if method not in (None, "dense", "threshold", "scan"):
        raise ConfigError(f"unknown method {method!r}")
    if ring:
        legacy = ("ring", threshold or method == "threshold")
    elif method == "threshold":
        legacy = ("host", True)
    elif method == "scan":
        legacy = ("scan", threshold)
    else:
        legacy = ("host", False)
    # The reference config resolves the legacy pair into order_backend at
    # construction, so a dict may already carry the mapped value.
    if order_backend not in ("host", legacy[0]):
        raise ConfigError(
            "pass either order_backend or the deprecated method/ring flags, "
            f"not both (got order_backend={order_backend!r}, "
            f"method={method!r}, ring={ring})"
        )
    return legacy


def config_from_reference(d: dict) -> ParaLiNGAMConfig:
    """The port's config for ``dataclasses.asdict`` of a JAX
    ``repro.ParaLiNGAMConfig``, so the port never imports ``repro``.

    Backend names map ``xla`` -> ``torch``, ``xla_fused`` -> ``torch_fused``,
    ``pallas_fused`` -> ``hopper_fused``; the deprecated flags map as the JAX
    package maps them. Raises ``ConfigError`` for what this port does not
    run (threshold, ring, a dtype other than float32)."""
    backend = _legacy_score_backend(d)
    if backend not in _BACKEND_NAMES:
        raise kops.BackendUnavailable(
            f"score_backend={backend!r} is not a reference backend "
            f"{tuple(_BACKEND_NAMES)}"
        )
    order_backend, threshold = _legacy_order(d)
    if d.get("ring_topology") is not None or order_backend == "ring":
        raise ConfigError(_NOT_PORTED["ring"])
    if threshold:
        raise ConfigError(_NOT_PORTED["threshold"])
    dtype = d.get("dtype", np.float32)
    if np.dtype(dtype) != np.float32:
        raise ConfigError(f"only float32 is ported, got dtype={dtype!r}")
    return ParaLiNGAMConfig(order_backend=order_backend,
                            score_backend=_BACKEND_NAMES[backend],
                            block_j=int(d.get("block_j", 32)),
                            min_bucket=int(d.get("min_bucket", 32)))


@dataclass
class ParaLiNGAMResult:
    order: list[int]
    comparisons: int  # unordered pair evaluations actually performed
    comparisons_dense: int  # sum_r r(r-1)/2 — messaging-only baseline
    comparisons_serial: int  # sum_r r(r-1)  — DirectLiNGAM baseline
    rounds: int  # threshold-loop rounds (0 for dense)
    per_iteration: list[dict] = field(default_factory=list)
    converged: bool = True  # False iff any threshold loop hit max_rounds
    noise_var: np.ndarray | None = None  # Omega diagonal (set by ``fit``)
    diagnostics: object | None = None  # core.validate.DatasetDiagnostics
    #   when the fit ran with validate=True

    @property
    def saving_vs_serial(self) -> float:
        return 1.0 - self.comparisons / max(self.comparisons_serial, 1)

    @property
    def saving_vs_messaging(self) -> float:
        return 1.0 - self.comparisons / max(self.comparisons_dense, 1)


# ---------------------------------------------------------------------------
# dense find-root and the staged scan
# ---------------------------------------------------------------------------


def _find_root_dense_impl(xb, cb, mask, block_j: int, backend: str,
                          n_valid=None, single: bool = False):
    """Concrete-backend dense evaluation of a bucket (``backend`` already
    resolved — never ``"auto"`` here): ``xb: (B, m, n)``, ``cb: (B, m, m)``,
    ``mask: (B, m)``, ``n_valid`` None or (B,). Returns ``(roots, scores)``
    with ``roots`` (B,) device indices (each dataset's first minimum, as
    ``jnp.argmin``).

    ``hopper_fused`` is one launch of the batched kernel per call; with
    ``single`` (``fit``'s bucket of one) it is the one-dataset kernel entry
    instead. The plain backends score each dataset on its own."""
    if backend == "hopper_fused":
        if single:
            nv = None if n_valid is None else n_valid[0]
            s = kops.score_vector(xb[0], cb[0], mask[0], n_valid=nv)[None]
        else:
            s = kops.score_batch(xb, cb, mask, n_valid=n_valid)
    elif backend in ("torch", "torch_fused"):
        rows = []
        for i in range(xb.shape[0]):
            nv = None if n_valid is None else n_valid[i]
            if backend == "torch_fused":
                rows.append(fused_scores(xb[i], cb[i], mask[i],
                                         block=min(block_j, xb.shape[1]), n_valid=nv))
            else:
                hx = row_entropies(xb[i], mask[i], n_valid=nv)
                hr = residual_entropy_matrix(xb[i], cb[i], n_valid=nv)
                rows.append(scores_from_stats(pair_stat_matrix(hx, hr), mask[i]))
        s = torch.stack(rows)
    else:
        raise kops.BackendUnavailable(f"no dense evaluation for {backend!r}")
    return torch.argmin(s, dim=-1), s


def _compact(mloc, m: int):
    """(B, m) indices that pack each dataset's live rows first (ascending),
    then fill up to ``m`` rows — ``jnp.nonzero(mloc, size=m)`` per dataset,
    without a sync."""
    sel = torch.argsort((~mloc).to(torch.int8), dim=-1, stable=True)[:, :m]
    if sel.shape[1] < m:
        sel = torch.cat([sel, sel.new_zeros(sel.shape[0], m - sel.shape[1])], dim=1)
    return sel


def _rows(t, sel):
    """``t[b, sel[b]]`` for every dataset b: rows of a (B, p, k) tensor."""
    return torch.take_along_dim(t, sel[:, :, None], dim=1)


def _scan_order_impl(xn, c, mask0=None, n_valid=None, block_j: int = 32,
                     backend: str = "torch", min_bucket: int = 32,
                     single: bool = False):
    """Device-resident outer loop over a bucket: all p find-root -> update
    iterations of every dataset, with no host round-trip.

    ``xn: (B, p, n)`` normalized rows and ``c: (B, p, p)`` correlations.
    ``mask0`` ((B, p) bool, None -> all live) marks each dataset's live
    rows; dead rows must be exactly zero in ``xn``. ``n_valid`` (None or
    (B,)) is each dataset's valid sample count. The stage plan is static: a
    dataset with fewer live rows drains early, after which its iterations
    retire nothing and write garbage order entries past its live prefix
    (``adjacency.complete_order`` sanitizes them). Live counts therefore
    come from the device (``sum(mask)``), never from ``p - iteration``.

    Each stage runs its iterations on fixed-size mask-based buffers, and the
    stage transitions compact each dataset's live rows with a device-side
    gather. Dead rows stay in the buffers (their content is never read
    unmasked), so ``argmin`` over the ``+inf`` dead scores resolves ties like
    the JAX driver.

    Returns ``(order, comps_it)``: the (B, p) causal orders and the (B, p)
    per-iteration comparison counts r(r-1)/2, both device tensors."""
    bsz, p = xn.shape[:2]
    dev = xn.device
    order = torch.zeros((bsz, p), dtype=torch.int64, device=dev)
    comps_it = torch.zeros((bsz, p), dtype=torch.int64, device=dev)
    if p == 1:
        return order, comps_it

    idx_g = torch.arange(p, device=dev).expand(bsz, p)  # local row -> variable id
    xb, cb = xn, c
    mloc = torch.ones((bsz, p), dtype=torch.bool, device=dev) if mask0 is None else mask0
    m_cur = p
    pos = 0
    for m, cnt in make_schedule(p, min_bucket).stages:
        if m != m_cur:
            live = torch.sum(mloc, dim=1, keepdim=True)
            sel = _compact(mloc, m)
            idx_g = torch.take_along_dim(idx_g, sel, dim=1)
            xb = _rows(xb, sel)
            cb = torch.take_along_dim(_rows(cb, sel), sel[:, None, :], dim=2)
            mloc = torch.arange(m, device=dev) < live
            m_cur = m
        ar = torch.arange(m, device=dev)
        for it in range(pos, pos + cnt):
            roots, _ = _find_root_dense_impl(xb, cb, mloc, block_j=min(block_j, m),
                                             backend=backend, n_valid=n_valid,
                                             single=single)
            r = torch.sum(mloc, dim=1)  # live rows this iteration
            order[:, it] = torch.take_along_dim(idx_g, roots[:, None], dim=1)[:, 0]
            comps_it[:, it] = r * (r - 1) // 2
            xb = update_data(xb, cb, roots, mloc, n_valid=n_valid)
            cb = update_cov(cb, roots, mloc)
            mloc = mloc & (ar != roots[:, None])
        pos += cnt

    # One live row remains (for a full buffer); no find-root needed. An
    # already-drained padded buffer writes garbage here, past its live prefix.
    last = torch.argmax(mloc.to(torch.int8), dim=1, keepdim=True)
    order[:, p - 1] = torch.take_along_dim(idx_g, last, dim=1)[:, 0]
    return order, comps_it


def _result_from_counters(order, comps_it, p: int) -> ParaLiNGAMResult:
    """Host-side ParaLiNGAMResult from the device counters of the scan (the
    one host readback point)."""
    order_np = order.cpu().numpy()
    comps_np = comps_it.cpu().numpy()
    per_iter = [
        {"r": r, "comparisons": int(comps_np[i]), "rounds": 0, "converged": True}
        for i, r in enumerate(range(p, 1, -1))
    ]
    comps_dense = sum(r * (r - 1) // 2 for r in range(2, p + 1))
    return ParaLiNGAMResult(
        order=[int(v) for v in order_np],
        comparisons=int(comps_np.sum()),
        comparisons_dense=comps_dense,
        comparisons_serial=2 * comps_dense,
        rounds=0,
        per_iteration=per_iter,
        converged=True,
    )


def _device(device, caller: str = "repro_torch.fit") -> torch.device:
    """``None`` means the card; raise rather than fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller} runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch path on the CPU"
        )
    return dev


# Host-side estimator dispatch counters, threaded up into the serving stats
# surface (``serve.async_engine.AsyncLingamEngine.stats``).
#
#   "kernel_bypass"  — dispatches where a kernel backend was requested but a
#     plain torch formulation ran instead. Every backend serves every seam
#     (``n_valid``, masks, batching), so nothing increments it: it is the
#     tripwire the engine tests hold at 0.
#   "auto_downgrade" — dispatches where ``score_backend="auto"`` resolved to
#     a plain torch backend (``kernels.ops.select_backend``: any device that
#     is not the card). Expected on the CPU; surfaced in
#     ``AsyncLingamEngine.stats()`` so a deployment can tell "kernels were
#     never requested" from "kernels silently unavailable".
dispatch_stats: dict = {"kernel_bypass": 0, "auto_downgrade": 0}
# Submitter and dispatcher-replica threads all count through _bump_stat.
_dispatch_stats_mu = threading.Lock()


def reset_dispatch_stats() -> None:
    """Zero ``dispatch_stats`` (tests). Thread-safe against concurrent
    dispatches."""
    with _dispatch_stats_mu:
        for k in dispatch_stats:
            dispatch_stats[k] = 0


def dispatch_stats_snapshot() -> dict:
    """Consistent point-in-time copy of ``dispatch_stats``."""
    with _dispatch_stats_mu:
        return dict(dispatch_stats)


def _bump_stat(key: str, delta: int = 1) -> None:
    """Thread-safe ``dispatch_stats`` increment."""
    with _dispatch_stats_mu:
        dispatch_stats[key] += delta


def _note_backend(cfg: ParaLiNGAMConfig, backend: str) -> None:
    """Count an ``"auto"`` request that resolved to a plain torch backend."""
    if cfg.score_backend == "auto" and backend.startswith("torch"):
        _bump_stat("auto_downgrade")


def _pipeline(x, cfg: ParaLiNGAMConfig, backend: str, *, adjacency: bool,
              n_valid=None, mask0=None, prune_below: float = 0.0,
              single: bool = False):
    """The whole estimator over a bucket ``x: (B, p, n)`` of raw samples:
    normalize -> covariance -> staged causal-order scan -> (optionally)
    phase-2 adjacency, all device work. Returns ``(order, comps_it, b,
    omega)`` (the last two ``None`` without ``adjacency``); phase 2 takes the
    raw ``x`` and the completed order permutation, like the numpy oracle."""
    xn = normalize(x, n_valid=n_valid)
    if mask0 is not None:
        xn = torch.where(mask0[..., None], xn, 0.0)  # dead rows exactly zero
    c = cov_matrix(xn, n_valid=n_valid)
    p = x.shape[1]
    order, comps_it = _scan_order_impl(
        xn, c, mask0=mask0, n_valid=n_valid, block_j=min(cfg.block_j, p),
        backend=backend, min_bucket=cfg.min_bucket, single=single,
    )
    if not adjacency:
        return order, comps_it, None, None
    perm = order if mask0 is None else complete_order(order, mask0)
    b, omega = adjacency_from_order(x, perm, mask=mask0, n_valid=n_valid,
                                    prune_below=prune_below)
    return order, comps_it, b, omega


def fit(x, config: ParaLiNGAMConfig | None = None, prune_below: float = 0.0,
        *, validate: bool = False, device=None):
    """Full DirectLiNGAM pipeline: causal order (step 1) + causal strengths B
    and noise variances (step 2). Returns ``(result, B)`` with ``B`` a (p, p)
    float32 tensor on the device and ``result.noise_var`` the Omega diagonal.

    ``x: (p, n)`` raw samples (numpy or torch), taken as float32. ``device``
    is where the fit runs: ``None`` means ``cuda`` (and raises without a
    CUDA device); ``"cpu"`` runs the plain torch path. Its float32 matmuls
    run at full precision (TF32 off, see ``covariance.full_precision_matmul``):
    the order depends on the correlations. The caller's setting is restored.

    ``validate=True`` runs the :mod:`repro_torch.core.validate` admission
    checks first and raises a typed ``DatasetError`` before any device work;
    the clean diagnostics land in ``result.diagnostics``."""
    cfg = config or ParaLiNGAMConfig()
    dev = _device(device)
    backend = kops.select_backend(cfg, dev)
    _note_backend(cfg, backend)
    diag = None
    if validate:
        from repro_torch.core.validate import require_valid

        x_host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        diag = require_valid(x_host)

    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    order, comps_it, b, omega = _pipeline(x[None], cfg, backend, adjacency=True,
                                          prune_below=prune_below, single=True)
    result = _result_from_counters(order[0], comps_it[0], x.shape[0])
    result.noise_var = omega[0].cpu().numpy()
    result.diagnostics = diag
    return result, b[0]


# ---------------------------------------------------------------------------
# the batched frontend
# ---------------------------------------------------------------------------


@dataclass
class BatchFitResult:
    """Batched estimator outputs, one leading dataset axis everywhere.

    All fields are tensors on the fit's device — nothing is read back until
    the caller reads them. ``orders[i]`` is valid up to the i-th dataset's
    live-row count (the serve engine slices); ``comparisons``/``rounds`` are
    per-iteration counters (sum for totals), ``converged`` per-iteration
    threshold convergence (``all`` for the dataset verdict; the dense scan
    always converges). ``b``/``noise_var`` are None for order-only runs."""

    orders: torch.Tensor  # (B, p) int64
    comparisons: torch.Tensor  # (B, p) int64
    rounds: torch.Tensor  # (B, p) int32
    converged: torch.Tensor  # (B, p) bool
    b: torch.Tensor | None = None  # (B, p, p)
    noise_var: torch.Tensor | None = None  # (B, p)


def _coerce_batch(xs, n_valid, mask, caller: str, dev):
    """Shared frontend validation of the batched entry points: the (B, p, n)
    float32 stack and the per-dataset padding seams, on the device."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    if xs.ndim != 3:
        raise ValueError(f"{caller} wants (B, p, n), got {tuple(xs.shape)}")
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
        nv = nv.expand(xs.shape[0]) if nv.ndim == 0 else nv
    mk = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=dev)
    return xs, nv, mk


def _run_batch(xs, config, n_valid, mask, device, caller: str, *,
               adjacency: bool, prune_below: float = 0.0) -> BatchFitResult:
    cfg = config or ParaLiNGAMConfig()
    dev = _device(device, caller)
    backend = kops.select_backend(cfg, dev)
    _note_backend(cfg, backend)
    xs, nv, mk = _coerce_batch(xs, n_valid, mask, caller, dev)
    order, comps, b, omega = _pipeline(xs, cfg, backend, adjacency=adjacency,
                                       n_valid=nv, mask0=mk, prune_below=prune_below)
    return BatchFitResult(
        orders=order, comparisons=comps,
        rounds=torch.zeros(order.shape, dtype=torch.int32, device=dev),
        converged=torch.ones(order.shape, dtype=torch.bool, device=dev),
        b=b, noise_var=omega)


def fit_batch(xs, config: ParaLiNGAMConfig | None = None, *, n_valid=None,
              mask=None, prune_below: float = 0.0, device=None) -> BatchFitResult:
    """Batched DirectLiNGAM over ``xs: (B, p, n)``: the pipeline of
    :func:`fit` over a leading dataset axis, so B problems share every torch
    op and one launch of the batched score kernel per find-root (the
    amortization of host cost per iteration the serve engine is built on).

    ``n_valid`` ((B,) or scalar) and ``mask`` ((B, p) bool) mark the valid
    sample columns / live variable rows of shape-padded datasets (zero-pad
    the data; see ``serve.buckets.pad_dataset``). ``device`` as in
    :func:`fit`: ``None`` means ``cuda`` and raises without a card. There is
    no mesh to shard the dataset axis over (ROADMAP.md queue 1 item 8)."""
    return _run_batch(xs, config, n_valid, mask, device, "fit_batch",
                      adjacency=True, prune_below=prune_below)


def causal_order_batch(xs, config: ParaLiNGAMConfig | None = None, *,
                       n_valid=None, mask=None, device=None) -> BatchFitResult:
    """Batched causal order only (phase 1): :func:`fit_batch` without the
    adjacency epilogue (``b`` and ``noise_var`` are None)."""
    return _run_batch(xs, config, n_valid, mask, device, "causal_order_batch",
                      adjacency=False)


@dataclass
class CompiledFitBatch:
    """:func:`fit_batch` warmed up for ONE ``(batch, p, n)`` bucket shape
    (see :func:`aot_fit_batch`). Calling it mirrors ``fit_batch`` (same
    result type, same padding contract) on inputs of exactly that shape.

    PyTorch compiles nothing per shape; what a bucket's first request would
    otherwise pay is the kernel library's build and load, the device
    context, the math libraries' handles, the allocator's first blocks and
    the kernel's tile maps per stage. The warm-up paid them, and
    ``compile_seconds`` (the name the JAX package gives it) is what it took."""

    batch: int
    p: int
    n: int
    cfg: ParaLiNGAMConfig
    backend: str  # concrete score backend the bucket runs
    device: torch.device
    compile_seconds: float  # what the warm-up saved the first request

    def __call__(self, xs, n_valid=None, mask=None) -> BatchFitResult:
        if tuple(xs.shape) != (self.batch, self.p, self.n):
            raise ValueError(
                f"CompiledFitBatch is specialized to "
                f"{(self.batch, self.p, self.n)}, got {tuple(xs.shape)}")
        return fit_batch(xs, self.cfg, n_valid=n_valid, mask=mask,
                         device=self.device)


def aot_fit_batch(batch: int, p: int, n: int,
                  config: ParaLiNGAMConfig | None = None, *,
                  device=None) -> CompiledFitBatch:
    """Warm up the :func:`fit_batch` path for one ``(batch, p, n)`` bucket:
    run one fit at that shape on seeded Gaussian data, through the
    ``n_valid``/mask seams a padded bucket uses, and wait for it. That builds
    and loads the kernel library on the card; after it, the bucket's first
    request pays no build, module load or library-handle setup. The serving
    engines call this over their bucket grid
    (``AsyncLingamEngine(prewarm=...)``)."""
    cfg = config or ParaLiNGAMConfig()
    dev = _device(device, "aot_fit_batch")
    backend = kops.select_backend(cfg, dev)
    t0 = time.perf_counter()
    xs = np.random.default_rng(0).standard_normal((batch, p, n)).astype(np.float32)
    res = fit_batch(xs, cfg, n_valid=np.full((batch,), n, np.int32),
                    mask=np.ones((batch, p), bool), device=dev)
    res.orders.cpu()  # wait for the device
    return CompiledFitBatch(batch=batch, p=p, n=n, cfg=cfg, backend=backend,
                            device=dev, compile_seconds=time.perf_counter() - t0)


__all__ = ["BatchFitResult", "CompiledFitBatch", "ConfigError",
           "ParaLiNGAMConfig", "ParaLiNGAMResult", "aot_fit_batch",
           "causal_order_batch", "config_from_reference",
           "dispatch_stats_snapshot", "fit", "fit_batch",
           "reset_dispatch_stats"]

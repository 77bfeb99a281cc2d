"""ParaLiNGAM (Algorithms 3 and 9-10 of the paper) in PyTorch: the dense
estimator end to end on one device.

``fit`` runs the whole pipeline as device work with one host readback at the
end: normalize -> covariance -> the staged causal-order scan (p find-root ->
rank-1-update iterations on the power-of-two stage plan of
``utils/schedule``) -> phase-2 adjacency by Cholesky. Each find-root is the
one-shot dense evaluation with messaging folded in: every residual entropy
is computed once and both workers of a pair are credited (Section 3.1).

The rows still in U are compacted into power-of-two buffers at the <= log2 p
stage transitions, with a stable ``argsort`` of the dead-row mask (no
``nonzero``, which syncs to the host); the per-iteration counters stay on
the device until :func:`_result_from_counters`.

Not in this module yet (``ConfigError`` names the ROADMAP item that brings
each): the threshold state machine (``threshold=True``), the messaging ring
(``order_backend="ring"``), the batched frontend and the host driver.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.adjacency import adjacency_from_order
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


def _find_root_dense_impl(xn, c, mask, block_j: int, backend: str):
    """Concrete-backend dense evaluation (``backend`` already resolved —
    never ``"auto"`` here). Returns ``(root, scores)`` with ``root`` a 0-dim
    device tensor (the first minimum, as ``jnp.argmin``)."""
    if backend == "hopper_fused":
        s = kops.score_vector(xn, c, mask)
    elif backend == "torch_fused":
        s = fused_scores(xn, c, mask, block=min(block_j, xn.shape[0]))
    elif backend == "torch":
        hx = row_entropies(xn, mask)
        hr = residual_entropy_matrix(xn, c)
        s = scores_from_stats(pair_stat_matrix(hx, hr), mask)
    else:
        raise kops.BackendUnavailable(f"no dense evaluation for {backend!r}")
    return torch.argmin(s), s


def _compact(mloc, m: int):
    """Indices that pack the live rows of ``mloc`` first (ascending), then
    fill up to ``m`` rows — ``jnp.nonzero(mloc, size=m)`` without a sync."""
    sel = torch.argsort((~mloc).to(torch.int8), stable=True)[:m]
    if sel.numel() < m:
        sel = torch.cat([sel, sel.new_zeros(m - sel.numel())])
    return sel


def _scan_order_impl(xn, c, block_j: int = 32, backend: str = "torch",
                     min_bucket: int = 32):
    """Device-resident outer loop: all p find-root -> update iterations with
    no host round-trip.

    The loop is staged on the power-of-two schedule; each stage runs its
    iterations on fixed-size mask-based buffers, and the stage transitions
    compact the live rows with a device-side gather. Dead rows stay in the
    buffers (their content is never read unmasked), so ``argmin`` over the
    ``+inf`` dead scores resolves ties like the JAX driver.

    Returns ``(order, comps_it)``: the causal order and the per-iteration
    comparison counts r(r-1)/2, both device tensors."""
    p = xn.shape[0]
    dev = xn.device
    order = torch.zeros((p,), dtype=torch.int64, device=dev)
    comps_it = torch.zeros((p,), dtype=torch.int64, device=dev)
    if p == 1:
        return order, comps_it

    idx_g = torch.arange(p, device=dev)  # local row -> global variable id
    xb, cb = xn, c
    mloc = torch.ones((p,), dtype=torch.bool, device=dev)
    m_cur = p
    pos = 0
    for m, cnt in make_schedule(p, min_bucket).stages:
        if m != m_cur:
            live = torch.sum(mloc)
            sel = _compact(mloc, m)
            idx_g = idx_g.index_select(0, sel)
            xb = xb.index_select(0, sel)
            cb = cb.index_select(0, sel).index_select(1, sel)
            mloc = torch.arange(m, device=dev) < live
            m_cur = m
        ar = torch.arange(m, device=dev)
        for it in range(pos, pos + cnt):
            root_l, _ = _find_root_dense_impl(xb, cb, mloc, block_j=min(block_j, m),
                                              backend=backend)
            r = torch.sum(mloc)  # live rows this iteration
            order[it:it + 1] = idx_g.index_select(0, root_l.reshape(1))
            comps_it[it:it + 1] = (r * (r - 1) // 2).reshape(1)
            xb = update_data(xb, cb, root_l, mloc)
            cb = update_cov(cb, root_l, mloc)
            mloc = mloc & (ar != root_l)
        pos += cnt

    # One live row remains; no find-root needed.
    order[p - 1:] = idx_g.index_select(0, torch.argmax(mloc.to(torch.int8)).reshape(1))
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


def _device(device) -> torch.device:
    """``None`` means the card; raise rather than fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.fit runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch path on the CPU"
        )
    return dev


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
    diag = None
    if validate:
        from repro_torch.core.validate import require_valid

        x_host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        diag = require_valid(x_host)

    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    p = x.shape[0]
    xn = normalize(x)
    c = cov_matrix(xn)
    order, comps_it = _scan_order_impl(
        xn, c, block_j=min(cfg.block_j, p), backend=backend,
        min_bucket=cfg.min_bucket,
    )
    b, omega = adjacency_from_order(x, order, prune_below=prune_below)
    result = _result_from_counters(order, comps_it, p)
    result.noise_var = omega.cpu().numpy()
    result.diagnostics = diag
    return result, b


__all__ = ["ConfigError", "ParaLiNGAMConfig", "ParaLiNGAMResult",
           "config_from_reference", "fit"]

"""ParaLiNGAM (Algorithms 3-6 and 9-10 of the paper) in PyTorch: the
estimator end to end on one device, for one dataset (``fit``) or a bucket of
datasets at once (``fit_batch``, what the serving engines call), and the
causal-order drivers on their own (``causal_order``, ``causal_order_scan``).

``fit`` and ``fit_batch`` run the whole pipeline as device work with one
host readback at the end: normalize -> covariance -> the staged causal-order
scan (p find-root -> rank-1-update iterations on the power-of-two stage plan
of ``utils/schedule``) -> phase-2 adjacency by Cholesky. Each find-root is
either the one-shot dense evaluation with messaging folded in (every
residual entropy computed once, both workers of a pair credited; Section
3.1) or, with ``threshold=True``, the paper's threshold state machine
(Sections 3.2-3.3, Algorithms 4-6), which stops comparing a worker once its
partial score exceeds the adaptive bound gamma.

The scan works on a leading dataset axis throughout (``fit`` is a bucket of
one), so a bucket of B datasets costs one set of torch ops and one kernel
launch per dense find-root, not B. The rows still in U are compacted into
power-of-two buffers at the <= log2 p stage transitions, per dataset, with
a stable ``argsort`` of the dead-row mask (no ``nonzero``, which syncs to
the host); the per-iteration counters stay on the device until they are
read. The dense scan never reads the host within a stage; the threshold
state machine reads one flag every ``READ_EVERY`` rounds (torch has no
device-side while loop).

``causal_order`` with ``order_backend="host"`` is the paper's host driver:
one ``int(root)`` read per iteration and buckets regathered from numpy
indices. ``order_backend="ring"`` runs the messaging ring
(``dist.ring_order.causal_order_ring``): one process per row shard over
``torch.distributed``, one shard and no collective without a process group.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.adjacency import adjacency_from_order, complete_order
from repro_torch.core.covariance import cov_matrix, normalize, update_cov, update_data
from repro_torch.core.pairwise import (
    fused_scores,
    pair_moments,
    pair_stat_matrix,
    residual_entropy_matrix,
    row_entropies,
    scores_from_stats,
)
from repro_torch.dist.sharding import NO_SHARDING, ShardingRules, gather_rows, row_block
from repro_torch.kernels import ops as kops
from repro_torch.utils.schedule import make_schedule
from repro_torch.utils.shapes import next_pow2


class ConfigError(ValueError):
    """A ``ParaLiNGAMConfig`` combination is contradictory, unknown, or not
    ported yet."""


#: Order drivers: ``host`` (the host loop of ``causal_order``; ``fit`` runs
#: the scan under it, as in the JAX package), ``scan`` (the device-resident
#: staged scan) and ``ring`` (the messaging ring, ``dist.ring_order``).
ORDER_BACKENDS = ("host", "scan", "ring")

#: Score backends whose scans also run the rank-1 updates through the
#: update kernel (``kernels.ops.rank1_update``); ``torch``/``torch_fused``
#: keep the plain ``covariance.update_data`` / ``update_cov``.
UPDATE_KERNEL_BACKENDS = ("hopper", "hopper_fused")

#: The estimator's dtypes (``ParaLiNGAMConfig.dtype``), by name.
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def kernel_update(backend: str, dtype: torch.dtype) -> bool:
    """Whether the scans, the host driver and the ring run their rank-1
    updates through the update kernel: under ``UPDATE_KERNEL_BACKENDS`` on a
    float32 state only. The kernel's fit and ring modes work in place on
    float32 buffers; a float64 state takes the torch updates in float64
    (``covariance.update_data`` / ``update_cov``, the ring's
    ``covupdate.ring_update_ref``), as the reference's fit takes its jnp
    updates in ``cfg.dtype`` and never calls its update kernels. The score
    kernels still run under float64, on float32 copies of their operands."""
    return backend in UPDATE_KERNEL_BACKENDS and dtype == torch.float32


def _torch_dtype(dtype) -> torch.dtype:
    """``torch.float32``/``torch.float64`` for a torch or numpy float dtype
    of either width or its name; ``ConfigError`` for anything else."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = None
    if name not in DTYPES:
        raise ConfigError(f"dtype={dtype!r} is not float32 or float64")
    return DTYPES[name]


@dataclass(frozen=True)
class ParaLiNGAMConfig:
    order_backend: str = "host"  # "host" | "scan" | "ring"
    #   (``ORDER_BACKENDS``): which loop ``causal_order`` runs. ``fit`` runs
    #   the scan under "host" and "scan", the ring under "ring";
    #   ``fit_batch`` has no ring form.
    ring_topology: tuple | None = None  # (P, R) pod/ring split of the ring's
    #   row shards (``order_backend="ring"`` only): P pods of R intra-pod
    #   shards walk ``utils.schedule.make_hier_plan``. None takes the split
    #   from the mesh (its ``pod`` dimension, else flat); (1, R) forces the
    #   flat ring. Both factors are powers of two, and P*R must equal the
    #   mesh's row-shard count at dispatch (``ConfigError`` otherwise).
    score_backend: str = "auto"  # "torch" | "torch_fused" | "hopper" |
    #   "hopper_fused" | "auto" (``kernels.ops.SCORE_BACKENDS``): the dense
    #   evaluation; ``auto`` resolves to the fused CUDA kernel on the card and
    #   the square plain path on the CPU
    block_j: int = 32  # block of the torch_fused sweep (min(block_j, m))
    # the threshold mechanism (paper Sections 3.2-3.3) in place of the dense
    # evaluation, under every order driver
    threshold: bool = False
    chunk: int = 16  # comparison targets per worker per round
    gamma0: float = 1e-5  # initial threshold (paper: "a small value")
    gamma_growth: float = 2.0  # the constant c of Algorithm 6 line 16
    max_rounds: int = 100_000
    # bucketed compaction of the remaining set U (the host driver's buckets;
    # the scan always compacts on the stage plan)
    bucket: bool = True
    min_bucket: int = 32  # floor of the power-of-two stage buffers
    # the estimator's floating dtype, float32 or float64 (torch or numpy, or
    # its name; stored as the torch dtype): every entry point casts its data
    # to it, and the state of the scan, the host driver and the ring, gamma
    # and phase 2 are in it. The hand score kernels stay float32 and take
    # float32 copies of their operands; so do the fused plain path's sweep
    # and the sample-count denominators, as in the JAX package.
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", _torch_dtype(self.dtype))
        if self.order_backend not in ORDER_BACKENDS:
            raise ConfigError(
                f"order_backend={self.order_backend!r} is not one of "
                f"{ORDER_BACKENDS}"
            )
        if self.ring_topology is not None:
            topo = tuple(self.ring_topology)
            if len(topo) != 2 or any(not isinstance(v, int) or v < 1 or v & (v - 1)
                                     for v in topo):
                raise ConfigError(
                    f"ring_topology={self.ring_topology!r} must be a (pods, ring) "
                    "pair of power-of-two positive ints")
            if self.order_backend != "ring":
                raise ConfigError(
                    "ring_topology is only meaningful with order_backend='ring' "
                    f"(got {self.order_backend!r})")
            object.__setattr__(self, "ring_topology", topo)


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


def resolve_order_backend(cfg) -> str:
    """A config's order driver as a concrete backend name (the counterpart of
    ``kernels.ops.select_backend`` for score backends). Raises
    :class:`ConfigError` for names outside ``ORDER_BACKENDS``."""
    backend = getattr(cfg, "order_backend", "host")
    if backend not in ORDER_BACKENDS:
        raise ConfigError(f"order_backend={backend!r} is not one of {ORDER_BACKENDS}")
    return backend


def config_from_reference(d: dict) -> ParaLiNGAMConfig:
    """The port's config for ``dataclasses.asdict`` of a JAX
    ``repro.ParaLiNGAMConfig``, so the port never imports ``repro``.

    Backend names map ``xla`` -> ``torch``, ``xla_fused`` -> ``torch_fused``,
    ``pallas`` -> ``hopper``, ``pallas_fused`` -> ``hopper_fused``; the
    deprecated flags map as the JAX package maps them, and ``jnp.float32``/
    ``jnp.float64`` to ``torch.float32``/``torch.float64``. Raises
    ``ConfigError`` for any other dtype."""
    backend = _legacy_score_backend(d)
    if backend not in _BACKEND_NAMES:
        raise kops.BackendUnavailable(
            f"score_backend={backend!r} is not a reference backend "
            f"{tuple(_BACKEND_NAMES)}"
        )
    order_backend, threshold = _legacy_order(d)
    topo = d.get("ring_topology")
    dflt = ParaLiNGAMConfig()
    return ParaLiNGAMConfig(
        order_backend=order_backend, score_backend=_BACKEND_NAMES[backend],
        ring_topology=None if topo is None else tuple(topo),
        block_j=int(d.get("block_j", dflt.block_j)), threshold=threshold,
        chunk=int(d.get("chunk", dflt.chunk)),
        gamma0=float(d.get("gamma0", dflt.gamma0)),
        gamma_growth=float(d.get("gamma_growth", dflt.gamma_growth)),
        max_rounds=int(d.get("max_rounds", dflt.max_rounds)),
        bucket=bool(d.get("bucket", dflt.bucket)),
        min_bucket=int(d.get("min_bucket", dflt.min_bucket)),
        dtype=d.get("dtype", np.float32))


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
    wire: dict | None = None  # the ring only: its point-to-point shift
    #   counters summed over the recovery, {"pods", "ring", "hops_intra",
    #   "hops_cross", "hops_overlapped", "seq_hops", "seq_cross_hops",
    #   "overlap_frac"} (``utils.schedule.HOP_*``; each iteration's equal
    #   ``HierPlan.hop_counts``, times its rounds under the threshold). None
    #   for the host and scan drivers.

    @property
    def saving_vs_serial(self) -> float:
        return 1.0 - self.comparisons / max(self.comparisons_serial, 1)

    @property
    def saving_vs_messaging(self) -> float:
        return 1.0 - self.comparisons / max(self.comparisons_dense, 1)


# ---------------------------------------------------------------------------
# dense find-root
# ---------------------------------------------------------------------------


def _find_root_dense_impl(xb, cb, mask, block_j: int, backend: str,
                          n_valid=None, single: bool = False):
    """Concrete-backend dense evaluation of a bucket (``backend`` already
    resolved — never ``"auto"`` here): ``xb: (B, m, n)``, ``cb: (B, m, m)``,
    ``mask: (B, m)``, ``n_valid`` None or (B,). Returns ``(roots, scores)``
    with ``roots`` (B,) device indices (each dataset's first minimum, as
    ``jnp.argmin``).

    ``hopper_fused`` and ``hopper`` are one launch of their batched kernel
    per call (the fused triangular sweep; the square moments over the live
    pairs and valid samples, with the row entropies, stat and scores as
    torch ops); with ``single`` (a bucket of one) they launch the
    one-dataset kernel entry instead. The plain
    backends score each dataset on its own."""
    if backend == "hopper_fused":
        if single:
            nv = None if n_valid is None else n_valid[0]
            s = kops.score_vector(xb[0], cb[0], mask[0], n_valid=nv)[None]
        else:
            s = kops.score_batch(xb, cb, mask, n_valid=n_valid)
    elif backend == "hopper":
        hx = row_entropies(xb, mask, n_valid=n_valid)
        if single:
            nv = None if n_valid is None else n_valid[0]
            hr = kops.residual_entropy_matrix(xb[0], cb[0], mask=mask[0], n_valid=nv)[None]
        else:
            hr = kops.residual_entropy_matrix_batch(xb, cb, mask=mask, n_valid=n_valid)
        # Dead pairs' entries (the entropy of zero sums) reach no score:
        # scores_from_stats drops them by select.
        s = scores_from_stats(pair_stat_matrix(hx, hr), mask)
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


def _operands(caller: str, device, xn, c, mask, n_valid=None):
    """One dataset's find-root operands as float and bool tensors on the
    device: the given one, else that of a tensor ``xn``, else the card. A
    float64 tensor ``xn`` keeps its dtype (``c`` is cast to it); anything
    else is taken as float32."""
    if device is None and isinstance(xn, torch.Tensor):
        device = xn.device
    dev = _device(device, caller)
    dtype = (torch.float64 if isinstance(xn, torch.Tensor) and xn.dtype == torch.float64
             else torch.float32)
    xn = torch.as_tensor(xn, dtype=dtype, device=dev).contiguous()
    c = torch.as_tensor(c, dtype=dtype, device=dev).contiguous()
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    nv = None if n_valid is None else torch.as_tensor(n_valid, device=dev).reshape(1)
    return xn[None], c[None], mask[None], nv


def find_root_dense(xn, c, mask, block_j: int = 32, n_valid=None, *,
                    score_backend: str = "auto", device=None):
    """One-shot masked dense evaluation of one dataset. Returns ``(root,
    scores)``: a 0-dim index tensor and the (p,) score vector (+inf on dead
    rows).

    ``xn: (p, n)`` normalized rows, ``c: (p, p)`` correlations, ``mask:
    (p,)`` live rows, ``n_valid`` the valid sample count of zero-padded
    data. ``score_backend`` selects the formulation
    (``kernels.ops.SCORE_BACKENDS``): the square plain path (``torch``), the
    fused triangular plain path (``torch_fused``) or the kernels
    (``hopper``: the square moments kernel; ``hopper_fused``: the fused
    triangular kernel). They run where the tensors lie (``device`` moves
    them; numpy inputs go to the card), in float64 for float64 tensors and
    in float32 otherwise; the kernels and ``torch_fused`` score float32
    copies, as in the JAX package."""
    xb, cb, mb, nv = _operands("find_root_dense", device, xn, c, mask, n_valid)
    backend = kops.select_backend(score_backend, xb.device)
    roots, s = _find_root_dense_impl(xb, cb, mb, block_j=min(block_j, xb.shape[1]),
                                     backend=backend, n_valid=nv, single=True)
    return roots[0], s[0]


# ---------------------------------------------------------------------------
# threshold find-root (paper Algorithms 4-6)
# ---------------------------------------------------------------------------

#: Rounds of the threshold state machine between two host reads of its
#: "is any dataset still running" flag. Rounds past a dataset's end leave its
#: state unchanged, so the value changes the host reads, never the result.
READ_EVERY = 4


def _still_running(run) -> bool:
    """The threshold loop's host read: is any dataset still running?"""
    return bool(run.any())


def _terminal(s, d, gamma, mask):
    """Algorithm 6's condition, per dataset: some below-threshold worker is
    finished and no below-threshold worker is unfinished."""
    below = (s < gamma[:, None]) & mask
    fin = torch.all(d, dim=-1)
    return torch.any(below & fin, dim=-1) & ~torch.any(below & ~fin, dim=-1)


def _find_root_threshold_impl(xn, c, mask, gamma0: float, gamma_growth: float,
                              chunk: int = 16, max_rounds: int = 100_000,
                              n_valid=None, read_every: int = READ_EVERY):
    """The threshold-mechanism find-root state machine over a bucket: ``xn:
    (B, m, n)``, ``c: (B, m, m)``, ``mask: (B, m)``, ``n_valid`` None or
    (B,). Returns ``(roots, scores, comparisons, rounds, converged)``, each
    with a leading (B,) axis.

    One round either (a) lets every *active* worker (score below gamma,
    comparisons pending) process its next pending chunk of ``chunk``
    comparison targets, crediting both ends of each pair (messaging) and
    keeping only the lower index of two workers that propose the same pair
    in one round (the paper's scheduler line 22), or (b) grows gamma by
    ``gamma_growth`` when no worker is active (Algorithm 6 lines 15-17). A
    dataset runs while ``~terminal & rounds < max_rounds & has_pairs`` holds;
    ``converged`` is False iff ``max_rounds`` cut it off before Algorithm 6's
    condition held (its scores may then be incomplete). A mask with fewer
    than two live rows has no pairs: that dataset does no round and reports
    converged with zero comparisons.

    This is ``jax.vmap`` of the JAX package's ``lax.while_loop`` written
    out: both branches are computed for every dataset and selected per
    dataset, and a dataset's state freezes once its own condition is false.
    The loop reads the batch's "any still running" flag on the host once
    every ``read_every`` rounds (the dense scan reads nothing within a
    stage); frozen datasets are unchanged by further rounds, so the counters
    and scores do not depend on ``read_every``.

    Three writes are kept free of run-to-run f32 drift: the reverse credits
    go to unique (row, col) slots of a zeroed (B, m, m) buffer summed over
    rows (no duplicate-index scatter-add, whose CUDA atomics reorder the
    sum), and the proposal and done matrices are plain index writes at
    unique positions."""
    bsz, m, _ = xn.shape
    dev = xn.device
    # Round the chunk down to a divisor of m so rows reshape into whole
    # chunks; worst case chunk=1, the paper's one-at-a-time worker.
    chunk = max(1, min(chunk, m))
    while m % chunk:
        chunk -= 1
    nc = m // chunk
    idx = torch.arange(m, device=dev)
    pair_valid = mask[:, :, None] & mask[:, None, :] & (idx[:, None] != idx[None, :])
    has_pairs = torch.any(pair_valid.reshape(bsz, -1), dim=-1)
    hx = row_entropies(xn, mask, n_valid=n_valid)
    bi = torch.arange(bsz, device=dev)[:, None, None]
    rows = idx[None, :, None].expand(bsz, m, chunk)
    offs = torch.arange(chunk, device=dev)

    s = torch.where(mask, 0.0, torch.inf).to(xn.dtype)
    d = ~pair_valid  # done := not a live pair (diagonal, dead rows and cols)
    # gamma and its growth factor in the state's dtype, as the reference's
    # jnp.asarray(gamma0, cfg.dtype)
    gamma = torch.full((bsz,), float(gamma0), dtype=xn.dtype, device=dev)
    gamma_growth = torch.full((), float(gamma_growth), dtype=xn.dtype, device=dev)
    comps = torch.zeros(bsz, dtype=torch.int64, device=dev)
    rounds = torch.zeros(bsz, dtype=torch.int32, device=dev)
    terminal = torch.zeros(bsz, dtype=torch.bool, device=dev)

    def running():
        return ~terminal & (rounds < max_rounds) & has_pairs

    while _still_running(running()):
        for _ in range(read_every):
            run = running()
            fin = torch.all(d, dim=-1)
            active = (s < gamma[:, None]) & ~fin & mask & run[:, None]
            grow = run & ~torch.any(active, dim=-1)

            pending = ~d & pair_valid
            pend_chunk = torch.any(pending.reshape(bsz, m, nc, chunk), dim=-1)
            ci = torch.argmax(pend_chunk.to(torch.int8), dim=-1)  # first pending
            cols = ci[..., None] * chunk + offs  # (B, m, chunk)
            hr_fwd, hr_rev = pair_moments(xn, torch.take_along_dim(c, cols, dim=2),
                                          xn[bi, cols], n_valid=n_valid)
            stat = (hx[bi, cols] - hx[..., None]) + (hr_fwd - hr_rev)

            proc = active[..., None] & torch.take_along_dim(pending, cols, dim=2)
            prop = torch.zeros_like(d).index_put((bi, rows, cols), proc)
            partner = torch.take_along_dim(prop.transpose(1, 2), cols, dim=2)
            keep = proc & (~partner | (rows < cols))

            fwd = torch.where(keep, torch.square(torch.clamp(stat, max=0.0)), 0.0)
            rev = torch.where(keep, torch.square(torch.clamp(-stat, max=0.0)), 0.0)
            rev_at = torch.zeros((bsz, m, m), dtype=s.dtype, device=dev).index_put(
                (bi, rows, cols), rev)
            s = (s + torch.sum(fwd, dim=-1)) + torch.sum(rev_at, dim=-2)
            d = d.index_put((bi, rows, cols), torch.take_along_dim(d, cols, dim=2) | keep)
            d = d.index_put((bi, cols, rows), d[bi, cols, rows] | keep)
            comps = comps + torch.sum(keep, dim=(1, 2))
            gamma = torch.where(grow, gamma * gamma_growth, gamma)
            rounds = rounds + run.to(torch.int32)
            terminal = torch.where(run, _terminal(s, d, gamma, mask), terminal)

    roots = torch.argmin(torch.where(mask, s, torch.inf), dim=-1)
    return roots, s, comps, rounds, terminal | ~has_pairs


def find_root_threshold(xn, c, mask, gamma0: float, gamma_growth: float,
                        chunk: int = 16, max_rounds: int = 100_000,
                        n_valid=None, *, device=None):
    """Threshold-mechanism find-root of one dataset. Returns ``(root,
    scores, comparisons, rounds, converged)`` as tensors (see
    ``_find_root_threshold_impl`` for the rounds); ``converged`` is False
    when ``max_rounds`` cut the loop off (Algorithm 6's condition never
    held, so the winning score may be partial). Operands as in
    :func:`find_root_dense`. The loop reads one flag on the host every
    ``READ_EVERY`` rounds."""
    xb, cb, mb, nv = _operands("find_root_threshold", device, xn, c, mask, n_valid)
    out = _find_root_threshold_impl(xb, cb, mb, gamma0, gamma_growth, chunk=chunk,
                                    max_rounds=max_rounds, n_valid=nv)
    return tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# the staged scan (Algorithm 3 on the device)
# ---------------------------------------------------------------------------


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
                     single: bool = False, threshold: bool = False,
                     chunk: int = 16, gamma0: float = 1e-5,
                     gamma_growth: float = 2.0, max_rounds: int = 100_000):
    """Device-resident outer loop over a bucket: all p find-root -> update
    iterations of every dataset, with no host round-trip (the threshold
    evaluation reads one flag every ``READ_EVERY`` of its rounds).

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
    the JAX driver. ``threshold=True`` runs the threshold state machine
    (``chunk``, ``gamma0``, ``gamma_growth``, ``max_rounds``) in place of the
    dense evaluation. Where :func:`kernel_update` says so (a kernel backend
    on a float32 state) each iteration's rank-1 updates are one launch of
    the update kernel for the bucket, which writes x' over the scan's own
    buffer once an update or a compaction has copied the caller's ``xn``
    (never over ``xn`` itself); otherwise ``covariance.update_data`` /
    ``update_cov`` in ``xn``'s dtype.

    Returns ``(order, comps_it, rounds_it, conv_it)``: the (B, p) causal
    orders and the (B, p) per-iteration comparison counts, threshold rounds
    and convergence flags, all device tensors (for the dense evaluation the
    analytic r(r-1)/2, 0 and True)."""
    bsz, p = xn.shape[:2]
    dev = xn.device
    order = torch.zeros((bsz, p), dtype=torch.int64, device=dev)
    comps_it = torch.zeros((bsz, p), dtype=torch.int64, device=dev)
    rounds_it = torch.zeros((bsz, p), dtype=torch.int32, device=dev)
    conv_it = torch.ones((bsz, p), dtype=torch.bool, device=dev)
    if p == 1:
        return order, comps_it, rounds_it, conv_it

    idx_g = torch.arange(p, device=dev).expand(bsz, p)  # local row -> variable id
    xb, cb = xn, c
    by_kernel = kernel_update(backend, xn.dtype)
    owned = False  # xb is the caller's xn until an update or a compaction copies it
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
            owned = True  # the gathers are the scan's own
        ar = torch.arange(m, device=dev)
        for it in range(pos, pos + cnt):
            if threshold:
                roots, _, comps, rounds, conv = _find_root_threshold_impl(
                    xb, cb, mloc, gamma0, gamma_growth, chunk=min(chunk, m),
                    max_rounds=max_rounds, n_valid=n_valid)
                rounds_it[:, it] = rounds
                conv_it[:, it] = conv
            else:
                roots, _ = _find_root_dense_impl(xb, cb, mloc, block_j=min(block_j, m),
                                                 backend=backend, n_valid=n_valid,
                                                 single=single)
                r = torch.sum(mloc, dim=1)  # live rows this iteration
                comps = r * (r - 1) // 2
            order[:, it] = torch.take_along_dim(idx_g, roots[:, None], dim=1)[:, 0]
            comps_it[:, it] = comps
            if by_kernel:  # one launch for the bucket; x' over the scan's own buffer
                xb, cb = kops.rank1_update(xb, cb, roots, mloc, n_valid, inplace=owned)
                owned = True
            else:
                xb = update_data(xb, cb, roots, mloc, n_valid=n_valid)
                cb = update_cov(cb, roots, mloc)
            mloc = mloc & (ar != roots[:, None])
        pos += cnt
    if by_kernel and dev.type == "cuda":
        _bump_stat("rank1_update", p - 1)  # one launch per iteration

    # One live row remains (for a full buffer); no find-root needed. An
    # already-drained padded buffer writes garbage here, past its live prefix.
    last = torch.argmax(mloc.to(torch.int8), dim=1, keepdim=True)
    order[:, p - 1] = torch.take_along_dim(idx_g, last, dim=1)[:, 0]
    return order, comps_it, rounds_it, conv_it


def _iteration_records(comps, rounds, conv, p: int, hops=None) -> list[dict]:
    return [{"r": r, "comparisons": int(comps[i]), "rounds": int(rounds[i]),
             "converged": bool(conv[i]),
             **({} if hops is None else {"hops": tuple(int(v) for v in hops[i])})}
            for i, r in enumerate(range(p, 1, -1))]


def _wire(hops, p: int, topology) -> dict:
    """``ParaLiNGAMResult.wire`` from the (p, 4) per-iteration shift
    counters of the ring (``utils.schedule.HOP_*``)."""
    io, is_, co, cs = (int(v) for v in hops[: max(p - 1, 0)].sum(axis=0))
    total = io + is_ + co + cs
    return {"pods": int(topology[0]), "ring": int(topology[1]),
            "hops_intra": io + is_, "hops_cross": co + cs, "hops_overlapped": io + co,
            "seq_hops": is_ + cs, "seq_cross_hops": cs,
            "overlap_frac": (io + co) / total if total else 0.0}


def _result_from_counters(order, comps_it, rounds_it, conv_it, p: int,
                          max_rounds: int, stacklevel: int = 3, hops_it=None,
                          topology: tuple = (1, 1)) -> ParaLiNGAMResult:
    """Host-side ParaLiNGAMResult from the device counters of the scan or
    the ring (the one host readback point). ``stacklevel`` points the
    ``max_rounds`` warning at the caller of the public entry point (3 = one
    public frame above this helper). The ring also passes ``hops_it``, its
    (p, 4) per-iteration shift counters, and its (pods, ring)
    ``topology``: they ride each ``per_iteration`` record as ``hops`` and
    sum into ``wire``."""
    comps_np = comps_it.cpu().numpy()
    rounds_np = rounds_it.cpu().numpy()
    conv_np = conv_it.cpu().numpy()
    hops_np = None if hops_it is None else hops_it.cpu().numpy()
    converged = bool(conv_np.all())
    if not converged:
        warnings.warn(
            f"find_root_threshold hit max_rounds={max_rounds} in "
            f"{int(p - 1 - conv_np[: p - 1].sum())} of {p - 1} scan iterations; "
            "scores may be incomplete (raise max_rounds or gamma_growth)",
            stacklevel=stacklevel,
        )
    comps_dense = sum(r * (r - 1) // 2 for r in range(2, p + 1))
    return ParaLiNGAMResult(
        order=[int(v) for v in order.cpu().numpy()],
        comparisons=int(comps_np.sum()),
        comparisons_dense=comps_dense,
        comparisons_serial=2 * comps_dense,
        rounds=int(rounds_np.sum()),
        per_iteration=_iteration_records(comps_np, rounds_np, conv_np, p, hops_np),
        converged=converged,
        wire=None if hops_np is None else _wire(hops_np, p, topology),
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
#   "rank1_update"   — launches of the update kernel (``kernels.ops.
#     rank1_update``) by the scans and the host driver: one per iteration
#     under a kernel backend on the card (p - 1 per ``fit``, p_pad - 1 per
#     dispatch); 0 on the CPU, where the wrapper runs its plain version.
dispatch_stats: dict = {"kernel_bypass": 0, "auto_downgrade": 0, "rank1_update": 0}
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


def _scan(xn, c, cfg: ParaLiNGAMConfig, backend: str, **kw):
    """``_scan_order_impl`` with the config's driver settings."""
    return _scan_order_impl(
        xn, c, block_j=min(cfg.block_j, xn.shape[1]), backend=backend,
        min_bucket=cfg.min_bucket, threshold=cfg.threshold, chunk=cfg.chunk,
        gamma0=cfg.gamma0, gamma_growth=cfg.gamma_growth,
        max_rounds=cfg.max_rounds, **kw)


def _pipeline(x, cfg: ParaLiNGAMConfig, backend: str, *, adjacency: bool,
              n_valid=None, mask0=None, prune_below: float = 0.0,
              single: bool = False):
    """The whole estimator over a bucket ``x: (B, p, n)`` of raw samples:
    normalize -> covariance -> staged causal-order scan -> (optionally)
    phase-2 adjacency, all device work. Returns ``(order, comps_it,
    rounds_it, conv_it, b, omega)`` (the last two ``None`` without
    ``adjacency``); phase 2 takes the raw ``x`` and the completed order
    permutation, like the numpy oracle."""
    xn = normalize(x, n_valid=n_valid)
    if mask0 is not None:
        xn = torch.where(mask0[..., None], xn, 0.0)  # dead rows exactly zero
    c = cov_matrix(xn, n_valid=n_valid)
    counters = _scan(xn, c, cfg, backend, mask0=mask0, n_valid=n_valid, single=single)
    if not adjacency:
        return (*counters, None, None)
    perm = counters[0] if mask0 is None else complete_order(counters[0], mask0)
    b, omega = adjacency_from_order(x, perm, mask=mask0, n_valid=n_valid,
                                    prune_below=prune_below)
    return (*counters, b, omega)


def fit(x, config: ParaLiNGAMConfig | None = None, prune_below: float = 0.0,
        *, validate: bool = False, device=None):
    """Full DirectLiNGAM pipeline: causal order (step 1) + causal strengths B
    and noise variances (step 2). Returns ``(result, B)`` with ``B`` a (p, p)
    tensor on the device and ``result.noise_var`` the Omega diagonal.

    ``x: (p, n)`` raw samples (numpy or torch), cast to ``config.dtype``
    (float32 unless it says float64; ``B`` and the noise variances come
    in it too). ``device``
    is where the fit runs: ``None`` means ``cuda`` (and raises without a
    CUDA device); ``"cpu"`` runs the plain torch path. Its float32 matmuls
    run at full precision (TF32 off, see ``covariance.full_precision_matmul``):
    the order depends on the correlations. The caller's setting is restored.
    The order comes from the staged scan, with the dense or the threshold
    evaluation per ``config.threshold``; :func:`causal_order` runs the host
    driver. With ``order_backend="ring"`` the order comes from the messaging
    ring (:func:`causal_order`, one shard per rank of the process group) and
    phase 2 runs on it, as the scan fit's does.

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

    x = torch.as_tensor(x, dtype=cfg.dtype, device=dev)
    if cfg.order_backend == "ring":
        result = causal_order(x, cfg, device=dev)
        order = torch.as_tensor(result.order, device=dev)
        b, omega = adjacency_from_order(x[None], order[None], prune_below=prune_below)
        result.noise_var = omega[0].cpu().numpy()
        result.diagnostics = diag
        return result, b[0]
    order, comps, rounds, conv, b, omega = _pipeline(
        x[None], cfg, backend, adjacency=True, prune_below=prune_below, single=True)
    result = _result_from_counters(order[0], comps[0], rounds[0], conv[0], x.shape[0],
                                   cfg.max_rounds)
    result.noise_var = omega[0].cpu().numpy()
    result.diagnostics = diag
    return result, b[0]


# ---------------------------------------------------------------------------
# the causal-order drivers on their own (phase 1)
# ---------------------------------------------------------------------------


def _normalized(x, cfg: ParaLiNGAMConfig, caller: str, device):
    dev = _device(device, caller)
    x = torch.as_tensor(x, dtype=cfg.dtype, device=dev)
    xn = normalize(x)[None]
    return xn, cov_matrix(xn), dev


def causal_order_scan(x, config: ParaLiNGAMConfig | None = None, *,
                      device=None) -> ParaLiNGAMResult:
    """Full causal order over ``x: (p, n)`` raw samples through the
    device-resident staged scan: the bucketed work profile of the host
    driver with no ``int(root)`` read per iteration. With
    ``config.threshold`` the scan runs the threshold state machine per
    iteration, and ``comparisons``/``rounds``/``per_iteration`` come from
    its device counters. ``device`` as in :func:`fit`."""
    cfg = config or ParaLiNGAMConfig()
    xn, c, dev = _normalized(x, cfg, "causal_order_scan", device)
    backend = kops.select_backend(cfg, dev)
    order, comps, rounds, conv = _scan(xn, c, cfg, backend, single=True)
    return _result_from_counters(order[0], comps[0], rounds[0], conv[0],
                                 xn.shape[1], cfg.max_rounds)


def _update_iteration(xn, c, root, mask, backend: str):
    """UpdateData + UpdateCovMat (Algorithms 7-8) of a bucket of one, and
    the root dropped from U. ``root`` is a (1,) tensor. Where
    :func:`kernel_update` says so, one launch of the update kernel, x'
    written over ``xn`` (the driver's own normalized copy)."""
    if kernel_update(backend, xn.dtype):
        xn2, c2 = kops.rank1_update(xn, c, root, mask, inplace=True)
    else:
        xn2 = update_data(xn, c, root, mask)
        c2 = update_cov(c, root, mask)
    mask2 = mask & (torch.arange(xn.shape[1], device=xn.device) != root[:, None])
    return xn2, c2, mask2


def causal_order(x, config: ParaLiNGAMConfig | None = None, *,
                 device=None) -> ParaLiNGAMResult:
    """ParaLiNGAM step 1: the full causal order over ``x: (p, n)`` raw
    samples. ``order_backend="ring"`` runs the messaging ring
    (``dist.ring_order.causal_order_ring`` over the process group, if any);
    ``"scan"`` runs :func:`causal_order_scan`;
    ``"host"`` the host driver (Algorithm 3): one find-root per iteration
    and one ``int(root)`` host read, the live rows regathered from numpy
    indices into a power-of-two bucket (``bucket=True``, floor
    ``min_bucket``) or the full masked buffer, then the rank-1 updates of
    the full (p, n) state. Each find-root is the dense evaluation or, with
    ``threshold=True``, the threshold state machine (which reads the host
    every ``READ_EVERY`` rounds). Per-iteration counters are read once, at
    the end. ``device`` as in :func:`fit`."""
    cfg = config or ParaLiNGAMConfig()
    driver = resolve_order_backend(cfg)
    if driver == "ring":
        from repro_torch.dist.ring_order import causal_order_ring

        return causal_order_ring(x, cfg, device=device)
    if driver == "scan":
        return causal_order_scan(x, cfg, device=device)
    xn, c, dev = _normalized(x, cfg, "causal_order", device)
    backend = kops.select_backend(cfg, dev)
    p = xn.shape[1]
    mask = torch.ones((1, p), dtype=torch.bool, device=dev)
    mask_np = np.ones((p,), bool)
    order: list[int] = []
    counters = []  # per iteration: (comparisons, rounds, converged) on the device
    for _ in range(p):
        live = np.flatnonzero(mask_np)
        r = len(live)
        if r == 1:
            order.append(int(live[0]))
            break
        if cfg.bucket:
            m = min(max(cfg.min_bucket, next_pow2(r)), next_pow2(p))
            idx_pad = np.full((m,), live[0], np.int64)
            idx_pad[:r] = live
            sel = torch.from_numpy(idx_pad).to(dev)
            xb = xn[:, sel]
            cb = c[:, sel][:, :, sel]
            mb = (torch.arange(m, device=dev) < r)[None]
        else:
            idx_pad = np.arange(p)
            xb, cb, mb = xn, c, mask
        m = xb.shape[1]
        if cfg.threshold:
            roots, _, comps, rounds, conv = _find_root_threshold_impl(
                xb, cb, mb, cfg.gamma0, cfg.gamma_growth, chunk=min(cfg.chunk, m),
                max_rounds=cfg.max_rounds)
            counters.append(torch.stack([comps[0], rounds[0].long(), conv[0].long()]))
        else:
            roots, _ = _find_root_dense_impl(xb, cb, mb, block_j=min(cfg.block_j, m),
                                             backend=backend, single=True)
        root = int(idx_pad[int(roots[0])])
        order.append(root)
        xn, c, mask = _update_iteration(xn, c, torch.tensor([root], device=dev), mask,
                                        backend)
        mask_np[root] = False
    if kernel_update(backend, xn.dtype) and dev.type == "cuda":
        _bump_stat("rank1_update", len(order) - 1)

    live_rows = np.arange(p, 1, -1)
    if counters:
        comps, rounds, conv = torch.stack(counters).cpu().numpy().T
        conv = conv.astype(bool)
    else:
        comps = live_rows * (live_rows - 1) // 2
        rounds, conv = np.zeros_like(comps), np.ones(comps.shape, bool)
    for i in np.flatnonzero(~conv):
        warnings.warn(
            f"find_root_threshold hit max_rounds={cfg.max_rounds} at iteration "
            f"{i} (r={live_rows[i]}); scores may be incomplete (raise max_rounds "
            "or gamma_growth)", stacklevel=2)
    comps_dense = sum(r * (r - 1) // 2 for r in range(2, p + 1))
    return ParaLiNGAMResult(
        order=order,
        comparisons=int(comps.sum()),
        comparisons_dense=comps_dense,
        comparisons_serial=2 * comps_dense,
        rounds=int(rounds.sum()),
        per_iteration=_iteration_records(comps, rounds, conv, p),
        converged=bool(conv.all()),
    )


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

    orders: torch.Tensor  # (B, p) int32, as in repro
    comparisons: torch.Tensor  # (B, p) int64
    rounds: torch.Tensor  # (B, p) int32
    converged: torch.Tensor  # (B, p) bool
    b: torch.Tensor | None = None  # (B, p, p)
    noise_var: torch.Tensor | None = None  # (B, p)


def _coerce_batch(xs, n_valid, mask, dev, dtype=torch.float32):
    """The (B, p, n) stack in ``dtype`` and the per-dataset padding seams of
    the batched entry points, on the device."""
    xs = torch.as_tensor(xs, dtype=dtype, device=dev)
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
        nv = nv.expand(xs.shape[0]) if nv.ndim == 0 else nv
    mk = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=dev)
    return xs, nv, mk


def numpy_dtype(dtype: torch.dtype):
    """The numpy counterpart of an estimator dtype (``DTYPES``)."""
    return np.float64 if dtype == torch.float64 else np.float32


def _reject_ring(cfg: ParaLiNGAMConfig, caller: str) -> None:
    if cfg.order_backend == "ring":
        raise ConfigError(
            f"{caller} runs the batched scan pipeline; the ring driver has no "
            "batched form: use order_backend='host'|'scan', or per-dataset "
            "fit() for the ring")


def _block(a, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a per-dataset seam (None and scalars as they are)."""
    if a is None or (a.ndim if isinstance(a, torch.Tensor) else np.ndim(a)) == 0:
        return a
    return a[lo:hi]


def _fit_local(xs, cfg: ParaLiNGAMConfig, dev, n_valid=None, mask=None, *,
               adjacency: bool = True, prune_below: float = 0.0) -> list:
    """The batched pipeline on the rows ``xs`` that this rank holds, with
    their seams: the rows of ``BatchFitResult``'s fields, in its order (no
    ``b``/``noise_var`` without ``adjacency``). No collective."""
    backend = kops.select_backend(cfg, dev)
    _note_backend(cfg, backend)
    xs, nv, mk = _coerce_batch(xs, n_valid, mask, dev, cfg.dtype)
    order, comps, rounds, conv, b, omega = _pipeline(
        xs, cfg, backend, adjacency=adjacency, n_valid=nv, mask0=mk,
        prune_below=prune_below)
    return [order.to(torch.int32), comps, rounds, conv] + ([b, omega] if adjacency else [])


def _fit_rows(xs, cfg: ParaLiNGAMConfig, rules: ShardingRules, dev, n_valid=None,
              mask=None, *, adjacency: bool = True, prune_below: float = 0.0):
    """``_fit_local`` on this rank's rows ``xs`` of a batch that ``rules``
    (``dist.sharding.row_block``'s) cut over its batch dimensions. Returns
    the whole batch's ``BatchFitResult`` on every rank: the results' rows
    all-gathered over the batch dimensions in one collective of one packed
    buffer (``dist.sharding.gather_rows``; none where the rows are all of
    the batch)."""
    return BatchFitResult(*gather_rows(_fit_local(
        xs, cfg, dev, n_valid, mask, adjacency=adjacency, prune_below=prune_below), rules))


def _run_batch(xs, config, n_valid, mask, device, caller: str, *,
               adjacency: bool, prune_below: float = 0.0, rules=None) -> BatchFitResult:
    cfg = config or ParaLiNGAMConfig()
    _reject_ring(cfg, caller)
    dev = _device(device, caller)
    if not isinstance(xs, torch.Tensor):
        xs = np.asarray(xs, numpy_dtype(cfg.dtype))
    if xs.ndim != 3:
        raise ValueError(f"{caller} wants (B, p, n), got {tuple(xs.shape)}")
    rules, lo, hi = row_block(xs.shape[0], NO_SHARDING if rules is None else rules)
    return _fit_rows(xs[lo:hi], cfg, rules, dev, _block(n_valid, lo, hi), _block(mask, lo, hi),
                     adjacency=adjacency, prune_below=prune_below)


def fit_batch(xs, config: ParaLiNGAMConfig | None = None, *, n_valid=None,
              mask=None, rules=None, prune_below: float = 0.0,
              device=None) -> BatchFitResult:
    """Batched DirectLiNGAM over ``xs: (B, p, n)``: the pipeline of
    :func:`fit` over a leading dataset axis, so B problems share every torch
    op and one launch of the batched score kernel per find-root (the
    amortization of host cost per iteration the serve engine is built on).

    ``n_valid`` ((B,) or scalar) and ``mask`` ((B, p) bool) mark the valid
    sample columns / live variable rows of shape-padded datasets (zero-pad
    the data; see ``serve.buckets.pad_dataset``). ``device`` as in
    :func:`fit`: ``None`` means ``cuda`` and raises without a card. A ring
    config raises ``ConfigError``: the ring has no batched form.

    ``rules`` (``dist.sharding.make_rules(cfg, mesh)`` with a ``"data"``
    axis) shards the dataset axis over the mesh's batch dimensions: every
    rank of the mesh calls ``fit_batch`` with the same ``xs``, runs the
    pipeline on its block of the datasets (all of them where the batch
    ranks do not divide B, as the reference's spec drops the axis; the
    model ranks alike), and returns the whole batch's results, gathered
    from the ranks in one collective. The pipeline takes each dataset
    alone, so the results equal the unsharded dispatch's bit for bit."""
    return _run_batch(xs, config, n_valid, mask, device, "fit_batch",
                      adjacency=True, prune_below=prune_below, rules=rules)


def causal_order_batch(xs, config: ParaLiNGAMConfig | None = None, *,
                       n_valid=None, mask=None, rules=None,
                       device=None) -> BatchFitResult:
    """Batched causal order only (phase 1): :func:`fit_batch` without the
    adjacency epilogue (``b`` and ``noise_var`` are None), with the same
    padding and sharding contracts."""
    return _run_batch(xs, config, n_valid, mask, device, "causal_order_batch",
                      adjacency=False, rules=rules)


@dataclass
class CompiledFitBatch:
    """:func:`fit_batch` warmed up for ONE ``(batch, p, n)`` bucket shape
    (see :func:`aot_fit_batch`). Calling it mirrors ``fit_batch`` (same
    result type, same padding and sharding contracts) on inputs of exactly
    that shape.

    PyTorch compiles nothing per shape; what a bucket's first request would
    otherwise pay is the kernel library's build and load, the device
    context, the math libraries' handles, the allocator's first blocks and
    the kernel's tile maps per stage. The warm-up paid them, and
    ``compile_seconds`` (the name the JAX package gives it) is what it took.
    ``padded`` calls always pass the ``n_valid``/mask seams (all valid where
    the caller gives none), as the reference's executable takes them; an
    exact (``padded=False``) one refuses them."""

    batch: int
    p: int
    n: int
    padded: bool  # run with the n_valid/mask seams (the serve path)
    cfg: ParaLiNGAMConfig
    backend: str  # concrete score backend the bucket runs
    device: torch.device
    compile_seconds: float  # what the warm-up saved the first request
    rules: ShardingRules | None = None
    prune_below: float = 0.0

    def __call__(self, xs, n_valid=None, mask=None) -> BatchFitResult:
        if tuple(xs.shape) != (self.batch, self.p, self.n):
            raise ValueError(
                f"CompiledFitBatch is specialized to "
                f"{(self.batch, self.p, self.n)}, got {tuple(xs.shape)}")
        if self.padded:
            n_valid = np.full((self.batch,), self.n, np.int32) if n_valid is None else n_valid
            mask = np.ones((self.batch, self.p), bool) if mask is None else mask
        elif n_valid is not None or mask is not None:
            raise ValueError(
                "this bucket was warmed up for exact (unpadded) batches; "
                "aot_fit_batch(padded=True) for the seams")
        return fit_batch(xs, self.cfg, n_valid=n_valid, mask=mask, rules=self.rules,
                         prune_below=self.prune_below, device=self.device)


def aot_fit_batch(batch: int, p: int, n: int,
                  config: ParaLiNGAMConfig | None = None, *, padded: bool = True,
                  rules=None, prune_below: float = 0.0,
                  device=None) -> CompiledFitBatch:
    """Warm up the :func:`fit_batch` path for one ``(batch, p, n)`` bucket:
    run one fit at that shape on seeded Gaussian data (through the
    ``n_valid``/mask seams a padded bucket uses, with ``padded``) and wait
    for it. That builds and loads the kernel library on the card; after it,
    the bucket's first request pays no build, module load or library-handle
    setup. With ``rules`` it is a collective, as ``fit_batch(rules=)`` is:
    every rank of the mesh calls it, and each fits and gathers its block.
    The serving engines call this over their bucket grid
    (``AsyncLingamEngine(prewarm=...)``)."""
    cfg = config or ParaLiNGAMConfig()
    _reject_ring(cfg, "aot_fit_batch")
    dev = _device(device, "aot_fit_batch")
    backend = kops.select_backend(cfg, dev)
    t0 = time.perf_counter()
    shard_rules, lo, hi = row_block(batch, NO_SHARDING if rules is None else rules)
    xs = np.random.default_rng(0).standard_normal((hi - lo, p, n)).astype(np.float32)
    seams = {}
    if padded:
        seams = dict(n_valid=np.full((hi - lo,), n, np.int32), mask=np.ones((hi - lo, p), bool))
    res = _fit_rows(xs, cfg, shard_rules, dev, prune_below=prune_below, **seams)
    res.orders.cpu()  # wait for the device
    return CompiledFitBatch(batch=batch, p=p, n=n, padded=padded, cfg=cfg, backend=backend,
                            device=dev, compile_seconds=time.perf_counter() - t0,
                            rules=rules, prune_below=prune_below)


__all__ = ["BatchFitResult", "CompiledFitBatch", "ConfigError",
           "ParaLiNGAMConfig", "ParaLiNGAMResult", "aot_fit_batch",
           "causal_order", "causal_order_batch", "causal_order_scan",
           "config_from_reference", "dispatch_stats_snapshot",
           "find_root_dense", "find_root_threshold", "fit", "fit_batch",
           "reset_dispatch_stats"]

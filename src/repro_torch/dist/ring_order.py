"""Ring-parallel *full* causal order: the paper's Section 3.1 worker ring as
the driver of all p DirectLiNGAM iterations, one process per shard.

``causal_order_ring`` keeps each rank's row block, correlation rows and
credit accumulators resident across the whole recovery on a
``("pod", "ring", "model")`` ``DeviceMesh``:

  * **pod x ring**: the p rows (and the matching correlation rows) shard
    into contiguous blocks over the P x R row grid (flat block index
    q * R + i, pod-major), as in ``ring.ring_find_root``. Each iteration
    runs the two-level messaging schedule of ``utils.schedule.
    make_hier_plan``, picks the root from the gathered (m,) score vector,
    then applies the Eq. (10)/(11) rank-1 data and correlation updates to
    each shard's own rows: only the root's data row (n/M floats) and the
    root's correlation column (m floats) cross the wire, never the blocks.
    The retired row is masked, not moved.
  * **model**: the samples shard over ``model``: every entropy moment is
    summed over n/M local samples and then across the model ranks before
    the entropy, which cuts the (m, n) data buffer and the circulating
    packets by M.

Each iteration evaluates the dense ring sweep (``ring._ring_body``) or, with
``threshold=True``, the threshold state machine per shard
(``ring._ring_threshold_body``).

The outer loop walks the stage plan the scan walks
(``utils.schedule.make_schedule`` with ``ring=R, pods=P``): block sizes are
fixed within a stage, and the <= log2 p stage changes gather the row blocks
and compact the live rows; those are the only points where rows move between
ranks. Every rank receives the whole (p, n) input (it takes its own block
and sample shard) and returns the whole order and counters.

The per-shard update is the scan's ``covariance.update_data`` and
``update_cov`` restricted to the own rows, with the root's data row and the
root column gathered from every shard, so at one shard it is bit-equal to
the scan's update. Under the ``hopper`` backends on a float32 state
(``core.paralingam.kernel_update``) it runs in the update kernel's ring mode
(``kernels.ops.ring_update``: one launch, or two around the sum of the
variances across the sample shards); otherwise its plain version, the torch
ops of ``covupdate.ring_update_ref``, in the state's dtype. The ring works
in ``config.dtype``; under float64 kernel #3 takes float32 copies of each
block (``kernels.ops``), as the scan's kernels do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.covariance import cov_matrix, normalize, rank1_gates
from repro_torch.core.paralingam import (
    ConfigError,
    ParaLiNGAMConfig,
    _compact,
    _device,
    _result_from_counters,
    causal_order_scan,
    kernel_update,
)
from repro_torch.dist.ring import RING_DIMS, Shards, _ring_body, _ring_threshold_body, ring_mesh
from repro_torch.kernels import ops as kops
from repro_torch.kernels.covupdate import ring_update_ref
from repro_torch.dist.sharding import mesh_sizes
from repro_torch.utils.schedule import make_schedule
from repro_torch.utils.shapes import next_pow2


# ---------------------------------------------------------------------------
# schedule (pure, unit-testable)
# ---------------------------------------------------------------------------


def ring_order_stages(p: int, min_bucket: int, r: int) -> list[tuple[int, int]]:
    """Static stage plan ``[(buffer size m, iteration count), ...]``: the
    topology-aware :func:`utils.schedule.make_schedule` with ring size ``r``.
    Each stage's m is a power of two, a multiple of ``r`` (so the m/r-row
    blocks stay equal and non-empty) and >= the live rows of every iteration
    it covers; the counts sum to p - 1. With r=1 it is the scan's plan."""
    return list(make_schedule(p, min_bucket, ring=r).stages)


# ---------------------------------------------------------------------------
# the staged ring driver
# ---------------------------------------------------------------------------


def _update_shard(x_loc, c_loc, mask, root, shards: Shards, n: int, backend: str = "torch"):
    """UpdateData and UpdateCovMat (Algorithms 7-8, Eqs. 10-11) on this
    rank's own rows, with the root (a device index into the stage buffer)
    still live in ``mask``. The root's data row comes from its owner (a sum
    of zeros and that row over the row blocks); the root's correlation
    column from every shard. Dead and root rows pass through (b = 0,
    s = 1, scale = 1), as in ``covariance.update_data`` / ``update_cov``.
    Under a ``hopper`` backend on a float32 state (``kernel_update``) the
    update kernel's ring mode does the arithmetic (its wrapper: the kernel
    on the card, the plain version on the CPU), written over ``x_loc`` and
    ``c_loc``; otherwise the plain version returns new tensors."""
    m_l, m = c_loc.shape
    dev = x_loc.device
    row0 = shards.flat * m_l
    row_ids = row0 + torch.arange(m_l, device=dev)
    owns = (root // m_l) == shards.flat
    r_l = (root % m_l).reshape(1)
    x_root = shards.sum_rows(torch.where(owns, torch.index_select(x_loc, 0, r_l)[0], 0.0))
    col = torch.index_select(c_loc, 1, root.reshape(1))[:, 0]  # c[own rows, root]
    live = mask[row0:row0 + m_l] & (row_ids != root)
    b, s_row = rank1_gates(col, live)
    # Columns: the gated root column over every row, dead columns and the
    # root passing through.
    b_col, s_col = rank1_gates(shards.gather_rows(col),
                               mask & (torch.arange(m, device=dev) != root))
    group = shards.sample_group
    reduce = None if group is None else (lambda sq: dist.all_reduce(sq, group=group))
    args = (x_loc, c_loc, x_root, b, s_row, b_col, s_col, live)
    if kernel_update(backend, x_loc.dtype):
        return kops.ring_update(*args, row0=row0, n=n, reduce=reduce, inplace=True)
    return ring_update_ref(*args, row0=row0, n=n, reduce=reduce)


def _ring_order(xn, c, shards: Shards, *, p: int, n: int, min_bucket: int, backend: str,
                threshold: bool, chunk: int, gamma0: float, gamma_growth: float,
                max_rounds: int):
    """Every find-root -> update iteration of one recovery on this rank.
    ``xn: (p, n_loc)`` is this rank's sample shard of every row, ``c`` the
    whole (p, p) correlations. Returns ``(order, comps_it, rounds_it,
    conv_it, hops_it)``, the same on every rank: the order and comparison
    counts on the device (the dense sweep reads nothing on the host), the
    rounds, convergence flags and (p, 4) shift counts on the host."""
    dev = xn.device
    order = torch.zeros((p,), dtype=torch.int64, device=dev)
    comps_it = torch.zeros((p,), dtype=torch.int64, device=dev)
    rounds_it = torch.zeros((p,), dtype=torch.int32)
    conv_it = torch.ones((p,), dtype=torch.bool)
    hops_it = torch.zeros((p, 4), dtype=torch.int32)
    sched = make_schedule(p, min_bucket, ring=shards.ring, pods=shards.pods,
                          sample_shards=shards.model)
    idx_g = torch.arange(p, device=dev)  # stage-buffer row -> variable id
    mk = torch.ones((p,), dtype=torch.bool, device=dev)  # live rows, on every rank
    xg, cg = xn, c  # every row: the input, then each compaction's gather
    x_loc = c_loc = None
    m_cur = p
    for m, cnt, pos in sched.walk():
        if m != m_cur:
            # Compaction (or the first pad to a power of two): the only
            # point where rows move between ranks.
            if x_loc is not None:
                xg, cg = shards.gather_rows(x_loc), shards.gather_rows(c_loc)
            sel = _compact(mk[None], m)[0]
            idx_g, xg, cg = idx_g[sel], xg[sel], cg[sel][:, sel]
            mk = torch.arange(m, device=dev) < p - pos  # one root retires per iteration
            x_loc, m_cur = None, m
        m_l = m // shards.blocks
        if x_loc is None:
            own = slice(shards.flat * m_l, (shards.flat + 1) * m_l)
            x_loc, c_loc = xg[own].contiguous(), cg[own].contiguous()
            xg = cg = None
        ar = torch.arange(m, device=dev)
        for it in range(pos, pos + cnt):
            if threshold:
                scores, comps, rounds, conv, hops = _ring_threshold_body(
                    x_loc, c_loc, mk, shards, gamma0=gamma0, gamma_growth=gamma_growth,
                    chunk=chunk, max_rounds=max_rounds)
                rounds_it[it], conv_it[it] = rounds, conv
            else:
                scores, hops = _ring_body(x_loc, c_loc, mk, shards, backend=backend)
                r = torch.sum(mk)
                comps = r * (r - 1) // 2
            root = torch.argmin(shards.gather_rows(scores))
            order[it] = idx_g[root]
            comps_it[it] = comps
            hops_it[it] = torch.tensor(hops, dtype=torch.int32)
            x_loc, c_loc = _update_shard(x_loc, c_loc, mk, root, shards, n, backend)
            mk = mk & (ar != root)
    # One live row remains; it needs no find-root.
    order[p - 1] = idx_g[torch.argmax(mk.to(torch.int8))]
    return order, comps_it, rounds_it, conv_it, hops_it


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def _canonical_mesh(mesh, n: int, pods: int | None = None, device_type: str = "cuda"):
    """Canonicalize a mesh to the ring's ``("pod", "ring", "model")`` form.

    The model size comes from the mesh's ``model`` dimension (1 without
    one); the other ranks split into ``pods`` rings (default: the mesh's
    ``pod`` dimension, 1 without one). ``mesh=None`` means every rank of the
    process group as one flat ring, and one shard with no collective when
    there is no process group; the mesh it builds for the process group is
    on ``device_type``. Returns ``(canon_mesh, pods, ring_size,
    sample_sharded)``: ``canon_mesh`` None without a process group, and
    ``sample_sharded`` False when the samples cannot shard (model size 1,
    or n not divisible by it). Raises ``ValueError`` when ``pods`` does not
    divide the row-shard count."""
    if mesh is None and not (dist.is_available() and dist.is_initialized()):
        if pods not in (None, 1):
            raise ValueError(f"pod count {pods} does not divide the 1 row shards")
        return None, 1, 1, False
    if mesh is None:
        ranks, msize, mesh_pods = torch.arange(dist.get_world_size()), 1, 1
    else:
        sizes = mesh_sizes(mesh)
        ranks = mesh.mesh.reshape(-1)
        msize, mesh_pods = sizes.get("model", 1), sizes.get("pod", 1)
    rows = ranks.numel() // msize
    if pods is None:
        pods = mesh_pods if rows % mesh_pods == 0 else 1
    if pods < 1 or rows % pods:
        raise ValueError(f"pod count {pods} does not divide the {rows} row shards")
    big_r = rows // pods
    canon = ring_mesh(mesh, ranks.reshape(pods, big_r, msize), RING_DIMS,
                      None if mesh is not None else device_type)
    return canon, pods, big_r, msize > 1 and n % msize == 0


def causal_order_ring(x, config=None, mesh=None, *, device=None):
    """Full causal order with the messaging ring as the outer-loop driver,
    called on every rank of ``mesh`` with the same ``x: (p, n)``.

    ``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_ring_mesh``), canonicalized
    by :func:`_canonical_mesh`: ``model`` -> sample sharding, ``pod`` -> the
    two-level ring's pod level, everything else -> the ring. Without one,
    every rank of the process group forms a flat ring, and without a process
    group the ring has one shard and calls no collective.
    ``config.ring_topology = (P, R)`` sets the pod/ring split: it must factor
    the row-shard count (``ConfigError`` otherwise); ``P=1`` forces the flat
    ring. A non-power-of-two pod or ring count falls back to
    ``causal_order_scan``: the same order, one shard.

    ``config.threshold`` selects the per-iteration evaluation: the dense
    messaging sweep (every live pair evaluated once, both endpoints
    credited), or the threshold state machine per shard. Either way the
    ``ParaLiNGAMResult`` counters are those of the host and scan drivers
    (the dense sweep's analytic r(r-1)/2, 0 rounds, converged), plus
    ``wire``: the shift counters of every iteration, summed.

    ``device`` is where the ring runs: the card unless the caller passes
    ``"cpu"`` (the CPU tests' gloo ranks), under any process group and
    whatever the mesh's device type; without a card it raises and never
    moves to the CPU on its own. Under gloo the ranks may share one card
    (``Shards.shift`` stages the packets through host buffers)."""
    cfg = config or ParaLiNGAMConfig()
    dev = _device(device, "causal_order_ring")
    x = torch.as_tensor(x, dtype=cfg.dtype, device=dev)
    p, n = x.shape
    want_pods = cfg.ring_topology[0] if cfg.ring_topology else None
    try:
        canon, pods, big_r, sample_sharded = _canonical_mesh(mesh, n, want_pods, dev.type)
    except ValueError as e:
        raise ConfigError(
            f"ring_topology={cfg.ring_topology} does not fit the device mesh: {e}") from e
    if cfg.ring_topology and cfg.ring_topology[1] != big_r:
        raise ConfigError(
            f"ring_topology={cfg.ring_topology} does not fit the device mesh: "
            f"{pods} pods leave {big_r} ring shards")
    if (big_r & (big_r - 1)) or (pods & (pods - 1)):
        return causal_order_scan(x, cfg, device=dev)

    shards = Shards(canon, sample_sharded=sample_sharded)
    xn = normalize(x)
    c = cov_matrix(xn)
    if shards.sample_group is not None:
        n_loc = n // shards.model
        mi = shards.coord["model"]
        xn = xn[:, mi * n_loc:(mi + 1) * n_loc]
    order, comps_it, rounds_it, conv_it, hops_it = _ring_order(
        xn, c, shards, p=p, n=n, min_bucket=next_pow2(max(cfg.min_bucket, 1)),
        backend=kops.select_backend(cfg, dev), threshold=cfg.threshold, chunk=cfg.chunk,
        gamma0=cfg.gamma0, gamma_growth=cfg.gamma_growth, max_rounds=cfg.max_rounds)
    return _result_from_counters(order, comps_it, rounds_it, conv_it, p, cfg.max_rounds,
                                 hops_it=hops_it, topology=(pods, big_r))

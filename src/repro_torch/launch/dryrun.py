"""Production dry run: every (architecture x input shape) cell of the port
on the production meshes, as one rank, on fake tensors over a fake
process group; per rank the memory, FLOPs, bytes and collectives.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell with XLA on 512 placeholder devices. The port compiles nothing:
this process plays one rank (``--rank``, default 0) of the mesh
(``launch.mesh.fake_world``: the ``"fake"`` process group, whose
collectives move nothing), builds that rank's cell (``launch.specs``:
its arguments as fake tensors, no memory) and runs the cell's function
once under

* ``FakeTensorMode``: every op computes shapes, dtypes and devices only;
* ``_Tracer``, one dispatch mode that counts the FLOPs of every op PyTorch's
  ``flop_counter`` knows (the products, convolutions and attentions), the
  bytes each op reads and writes (its inputs' and outputs'; views,
  allocations and collectives move nothing), and the live storages: each new untyped
  storage adds its bytes when an op first returns it and subtracts them
  when the last tensor on it dies, a view or an in-place result counted
  once, so the peak is this rank's peak allocation on top of its
  arguments; the live bytes at the peak are kept by the op that made each
  storage (``temp_by_op_at_peak``). On the card's path an op that the
  CUDA kernel runs with a workspace of its own counts it while the op runs
  (``workspace_bytes``: softmax's backward holds one as large as its
  output, the ``grad * output`` it computes first, measured on the H100
  for every shape and dtype tried, and a contiguous copy of a strided
  gradient or output, seen in the allocator's history of a strided
  attention backward), under ``"<op> workspace"``;
* ``utils.collectives.CollectiveLedger``: every collective the rank issues;
* ``kernels._fake.recording``: each hand kernel's fake calls and their
  FLOPs (``flops`` beside each wrapper), which no dispatch mode sees.

The record keeps the reference's keys: ``memory`` (``argument_size_in_bytes``:
parameters, optimizer state, caches and batch on this rank;
``output_size_in_bytes``; ``temp_size_in_bytes``: the peak less the
arguments; ``alias_size_in_bytes``: outputs written over arguments, in
place; ``generated_code_size_in_bytes``: 0), ``flops_per_device``,
``bytes_per_device``, ``collectives``, ``n_collective_ops``,
``mesh_kind``, ``fsdp_axes`` (the cell's: a train cell's data dimensions
of size > 1, empty for prefill and decode); and adds ``trace_s`` (in place
of ``lower_s`` and ``compile_s``), ``peak_bytes``, ``rank``, ``kernels``
(each hand kernel's launches), ``peak_tensors`` (the storages alive at
the peak, grouped by the op that made them, their shape and dtype: count
and bytes) and the path traced. Under FSDP each
gathered copy of a leaf and each reduce-scatter's output is a new
storage, counted as a temporary while it lives. Every number is a
prediction for one H100 rank of such a cluster, not a measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k --mesh single --out results/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/
  ... --cost-mode   # 1- and 2-group cells, extrapolated to the full depth
  ... --lingam      # the paper's own steps at the bucketed problem sizes
  ... --device cpu  # the plain path (default: the card's, on fake CUDA tensors)
  ... --jobs N      # N worker processes, one fake world each

On a torch built without CUDA the card's path is traced on fake CPU
tensors that stand for the card (``kernels._fake.stand_in``): the kernel
wrappers route them as fake CUDA tensors. The numbers are the same; the
record says so (``traced_on``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing as mp
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.kernels import _fake
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.launch.specs import Cell, Unsupported, make_cell, trace_device
from repro_torch.utils.collectives import CollectiveLedger, summarize_collectives

#: The reference's mesh kinds.
MESH_KINDS = {"single": False, "multi": True}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storages(tree) -> dict:
    """The distinct untyped storages under the tensors of ``tree``: key ->
    bytes."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            out[_storage_key(t)] = t.untyped_storage().nbytes()
    return out


def argument_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``'s tensors, real or
    fake: what ``argument_size_in_bytes`` counts."""
    return sum(storages(tree).values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: Ops that allocate and write nothing: no bytes moved.
_ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided"))


def workspace_bytes(op: str, args, outs) -> int:
    """The bytes the CUDA kernel of ``op`` allocates for itself while it
    runs, on these arguments (0 for an op without a workspace): softmax's
    backward computes ``grad * output`` into a new tensor, and first makes
    a strided gradient or output contiguous."""
    if op != "_softmax_backward_data":
        return 0
    strided = [t for t in args[:2] if isinstance(t, torch.Tensor) and not t.is_contiguous()]
    return sum(map(_nbytes, outs)) + sum(map(_nbytes, strided))


class _Tracer(TorchDispatchMode):
    """FLOPs, bytes and live storages of the ops run under it (above a
    ``FakeTensorMode``). ``known``: the arguments' storages, never counted
    as new; ``card``: the card's path (kernel workspaces counted,
    ``workspace_bytes``)."""

    def __init__(self, known, card: bool = False):
        super().__init__()
        self.known = set(known)
        self.card = card
        self.flops = 0.0
        self.bytes = 0
        self.live: dict = {}  # storage key -> [tensors alive on it, bytes, group]
        self.objs: set = set()  # ids of the tracked tensors alive
        self.total = 0
        self.peak = 0
        # (op that made it, shape, dtype) -> [storages, bytes] alive
        self.groups: dict = {}
        self.peak_groups: dict = {}  # ``groups`` at the peak

    def _release(self, obj_id: int, key: int):
        self.objs.discard(obj_id)
        entry = self.live[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.total -= entry[1]
            g = self.groups[entry[2]]
            g[0] -= 1
            g[1] -= entry[1]
            if g[0] == 0:
                del self.groups[entry[2]]
            del self.live[key]

    def _track(self, t: torch.Tensor, op: str):
        if id(t) in self.objs:
            return
        key = _storage_key(t)
        if key in self.known:
            return
        entry = self.live.get(key)
        if entry is None:
            group = (op, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            entry = self.live[key] = [0, t.untyped_storage().nbytes(), group]
            self.total += entry[1]
            g = self.groups.setdefault(group, [0, 0])
            g[0] += 1
            g[1] += entry[1]
            if self.total > self.peak:
                self.peak = self.total
                self.peak_groups = {k: tuple(v) for k, v in self.groups.items()}
        entry[0] += 1
        self.objs.add(id(t))
        weakref.finalize(t, self._release, id(t), key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("prim", "c10d"):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view and packet.__name__ not in _ALLOCATIONS:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t, packet.__name__)
        if self.card:
            self._workspace(packet.__name__, outs, workspace_bytes(packet.__name__, args, outs))
        return out

    def _workspace(self, op: str, outs, size: int):
        """A kernel's workspace of ``size`` bytes, alive while ``op`` runs
        (its inputs and output alive too): a peak if the total with it is
        one."""
        if size and self.total + size > self.peak:
            self.peak = self.total + size
            group = (f"{op} workspace", tuple(outs[0].shape),
                     str(outs[0].dtype).replace("torch.", ""))
            self.peak_groups = {**{k: tuple(v) for k, v in self.groups.items()},
                                group: (1, size)}

    @property
    def peak_by_op(self) -> dict:
        """The live bytes at the peak by the op that made them."""
        out: dict = {}
        for (op, _, _), (_, size) in self.peak_groups.items():
            out[op] = out.get(op, 0) + size
        return out

    def peak_tensors(self) -> list:
        """The live storages at the peak by (op, shape, dtype): count and
        bytes, the largest first."""
        return [{"op": op, "shape": list(shape), "dtype": dtype, "count": n, "bytes": b}
                for (op, shape, dtype), (n, b) in sorted(self.peak_groups.items(),
                                                         key=lambda kv: -kv[1][1])]


def _mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.shape)) if mesh is not None else "1"


def run_traced(fn, args, mode, *, stand_in: bool, card: bool = False):
    """Run ``fn(*args)`` once under ``mode`` and the counters (``card``:
    the card's path). Returns (outputs, tracer, ledger records, kernel
    calls, seconds)."""
    known = storages(args)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mode)
        if stand_in:
            stack.enter_context(_fake.stand_in())
        calls = stack.enter_context(_fake.recording())
        ledger = stack.enter_context(CollectiveLedger())
        tracer = stack.enter_context(_Tracer(known, card))
        out = fn(*args)
    return out, tracer, ledger.records, calls, time.perf_counter() - t0


def record(name: str, mesh, args, out, tracer, colls, calls, seconds, *, rank: int,
           device: str, traced_on: str, fsdp_axes: tuple = ()) -> dict:
    """The dry run's record of one traced call."""
    arg_st, out_st = storages(args), storages(out)
    arguments = sum(arg_st.values())
    kernels: dict = {}
    for kname, _ in calls:
        kernels[kname] = kernels.get(kname, 0) + 1
    return {
        "cell": name,
        "mesh": _mesh_name(mesh),
        "status": "ok",
        "trace_s": round(seconds, 3),
        "memory": {
            "argument_size_in_bytes": arguments,
            "output_size_in_bytes": sum(out_st.values()),
            "temp_size_in_bytes": tracer.peak,
            "alias_size_in_bytes": sum(v for k, v in out_st.items() if k in arg_st),
            "generated_code_size_in_bytes": 0,
        },
        "peak_bytes": arguments + tracer.peak,
        "temp_by_op_at_peak": {op: n for op, n in sorted(tracer.peak_by_op.items(),
                                                         key=lambda kv: -kv[1]) if n > 0},
        "peak_tensors": tracer.peak_tensors(),
        "flops_per_device": float(tracer.flops) + sum(f for _, f in calls),
        "bytes_per_device": float(tracer.bytes),
        "collectives": summarize_collectives(colls),
        "n_collective_ops": len(colls),
        "kernels": kernels,
        "rank": rank,
        "fsdp_axes": list(fsdp_axes),
        "device": device,
        "traced_on": traced_on,
    }


def trace_cell(cell: Cell, mesh, *, rank: int = 0, verbose: bool = True, then=None) -> dict:
    """Counterpart of the reference's ``compile_cell``: run ``cell`` once
    on its fake arguments, and its record. ``then``, a function of the
    cell's outputs, is traced with it (a caller's step around the cell)."""
    stand_in = cell.device == "cuda" and cell.traced_on != "cuda"
    fn = cell.fn if then is None else (lambda *args: then(cell.fn(*args)))
    out, tracer, colls, calls, seconds = run_traced(fn, cell.args, cell.mode, stand_in=stand_in,
                                                    card=cell.device == "cuda")
    rec = record(cell.name, mesh, cell.args, out, tracer, colls, calls, seconds, rank=rank,
                 device=cell.device, traced_on=cell.traced_on, fsdp_axes=cell.rules.fsdp_axes)
    rec.update(cell.info)
    if verbose:
        mm = rec["memory"]
        print(f"[ok] {cell.name:42s} mesh={rec['mesh']:8s} trace={seconds:6.1f}s "
              f"args/dev={mm['argument_size_in_bytes'] / 2**30:7.2f}GiB "
              f"peak/dev={rec['peak_bytes'] / 2**30:7.2f}GiB "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll={rec['collectives']['total_operand_bytes'] / 2**20:9.1f}MiB", flush=True)
    return rec


def cell_record(cfg, shape, mesh, *, rank: int, device: str, accum_steps: int = 4,
                 verbose: bool = True) -> dict:
    """``trace_cell`` of a fresh cell, or an ``unsupported`` record."""
    try:
        cell = make_cell(cfg, shape, mesh, accum_steps=accum_steps, device=device)
    except Unsupported as e:
        if verbose:
            print(f"[unsupported] {cfg.name}/{shape.name}: {e}", flush=True)
        return {"cell": f"{cfg.name}/{shape.name}", "mesh": _mesh_name(mesh),
                "status": "unsupported", "reason": str(e)}
    return trace_cell(cell, mesh, rank=rank, verbose=verbose)


def cost_mode_cell(cfg, shape, mesh, groups: tuple[int, int] = (1, 2), *, rank: int = 0,
                   device: str = "cuda") -> dict:
    """Cells of 1 and 2 groups (one microbatch: the costs of the whole
    global batch) -> the full depth's costs by the per-group delta, as the
    reference's ``cost_mode_cell``. An encoder-decoder model or one of at
    most two groups is traced whole."""
    full_groups = cfg.n_groups
    if cfg.enc_dec or full_groups <= 2:
        rec = cell_record(cfg, shape, mesh, rank=rank, device=device, accum_steps=1,
                           verbose=False)
        rec["cost_mode"] = "full_unroll"
        return rec
    recs = {}
    for g in groups:
        sub = cfg.with_overrides(n_groups_override=g)
        recs[g] = cell_record(sub, shape, mesh, rank=rank, device=device, accum_steps=1,
                               verbose=False)
        if recs[g]["status"] != "ok":
            return recs[g]
    g1, g2 = groups
    r1, r2 = recs[g1], recs[g2]
    span = g2 - g1

    def extrap(a, b):
        return a + (full_groups - g1) * (b - a) / span

    out = {
        "cell": f"{cfg.name}/{shape.name}",
        "mesh": r1["mesh"],
        "status": "ok",
        "cost_mode": f"delta_{g1}_{g2}",
        "flops_per_device": extrap(r1["flops_per_device"], r2["flops_per_device"]),
        "bytes_per_device": extrap(r1["bytes_per_device"], r2["bytes_per_device"]),
        "collectives": {
            "total_operand_bytes": extrap(r1["collectives"]["total_operand_bytes"],
                                          r2["collectives"]["total_operand_bytes"]),
            "total_wire_bytes": extrap(r1["collectives"]["total_wire_bytes"],
                                       r2["collectives"]["total_wire_bytes"]),
        },
        "n_collective_ops": extrap(r1["n_collective_ops"], r2["n_collective_ops"]),
        "trace_s": r1["trace_s"] + r2["trace_s"],
        "base_records": {str(g): recs[g] for g in groups},
    }
    print(f"[cost] {out['cell']:40s} flops/dev={out['flops_per_device']:.3e} "
          f"coll={out['collectives']['total_operand_bytes'] / 2**20:9.1f}MiB", flush=True)
    return out


def _lingam_steps(p: int, n: int, mesh, batch_axes: tuple):
    """The paper's steps at a bucket of p rows, as functions of (xn, c,
    mask): the dense find-root under ``torch`` (square, plain), the fused
    triangular find-root under ``hopper_fused`` (kernel #1), the ring's
    find-root under ``hopper`` (kernel #3 per shard, the rows over the
    batch dimensions) and the fit-mode update (``rank1_update``, kernels
    #4-#5)."""
    from repro_torch.core.paralingam import _find_root_dense_impl, _update_iteration
    from repro_torch.dist.ring import _find_root, ring_shards

    shards = ring_shards(mesh, p, n, row_axes=batch_axes)  # real rank tables, outside the trace

    def dense(xn, c, mask):
        return _find_root_dense_impl(xn[None], c[None], mask[None], min(128, p), "torch",
                                     single=True)

    def fused(xn, c, mask):
        return _find_root_dense_impl(xn[None], c[None], mask[None], min(128, p),
                                     "hopper_fused", single=True)

    def ring(xn, c, mask):  # ring_find_root(..., row_axes=batch_axes, score_backend="hopper")
        return _find_root(xn, c, mask, shards, "hopper")

    def update(xn, c, mask):
        root = torch.zeros((1,), dtype=torch.int64, device=xn.device)
        return _update_iteration(xn[None], c[None], root, mask[None], "hopper_fused")

    return (("find_root", dense), ("find_root_fused", fused), ("find_root_ring", ring),
            ("update", update))


def lingam_cells(mesh, *, rank: int = 0, device: str = "cuda") -> list[dict]:
    """The paper's own workload (``configs.LINGAM_CONFIGS`` at their
    bucketed sizes: p to a power of two, n to a multiple of 16), one
    record per step (``_lingam_steps``). Every rank holds the whole
    problem, as the ring's entry takes it; the dense and fused find-roots
    and the update run whole on every rank (the port splits them over no
    mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = []
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    dev = trace_device(device)
    for name, lc in configs.LINGAM_CONFIGS.items():
        p = 1 << (lc.p - 1).bit_length()
        n = (lc.n + 15) // 16 * 16
        for fn_name, fn in _lingam_steps(p, n, mesh, batch_axes):
            cell = f"{name}/{fn_name}"
            try:
                mode = FakeTensorMode()
                with mode:
                    args = (torch.empty((p, n), device=dev), torch.empty((p, p), device=dev),
                            torch.ones((p,), dtype=torch.bool, device=dev))
                res, tracer, colls, calls, seconds = run_traced(
                    fn, args, mode, stand_in=device == "cuda" and dev != "cuda")
                rec = record(cell, mesh, args, res, tracer, colls, calls, seconds, rank=rank,
                             device=device, traced_on=dev)
                rec.update({"p_bucket": p, "n_pad": n})
                print(f"[ok] {cell:42s} mesh={rec['mesh']:8s} trace={seconds:6.1f}s "
                      f"flops/dev={rec['flops_per_device']:.3e}", flush=True)
            except Exception as e:  # noqa: BLE001 -- a failed cell is a record
                rec = {"cell": cell, "status": "fail", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {cell}: {rec['error']}", flush=True)
            out.append(rec)
    return out


def _arch_cell(task) -> dict:
    """One (arch, shape) record of a mesh kind, in a fake world of its own
    (a worker's task; the main process runs them in turn without
    ``--jobs``)."""
    arch, shape_name, mesh_kind, rank, device, cost_mode = task
    cfg, shape = configs.get(arch), SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        print(f"[skip] {cfg.name}/{shape.name}: documented skip", flush=True)
        return {"cell": f"{cfg.name}/{shape.name}", "mesh_kind": mesh_kind,
                "status": "skipped", "reason": reason}
    with fake_world(*production_shape(MESH_KINDS[mesh_kind]), rank=rank) as mesh:
        try:
            rec = (cost_mode_cell(cfg, shape, mesh, rank=rank, device=device) if cost_mode
                   else cell_record(cfg, shape, mesh, rank=rank, device=device))
        except Exception as e:  # noqa: BLE001 -- a failed cell is a record
            rec = {"cell": f"{cfg.name}/{shape.name}", "status": "fail",
                   "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {cfg.name}/{shape.name}: {rec['error']}", flush=True)
    rec["mesh_kind"] = mesh_kind
    return rec


def _lingam_kind(task) -> list[dict]:
    mesh_kind, rank, device = task
    with fake_world(*production_shape(MESH_KINDS[mesh_kind]), rank=rank) as mesh:
        recs = lingam_cells(mesh, rank=rank, device=device)
    for rec in recs:
        rec["mesh_kind"] = mesh_kind
    return recs


def _run(fn, tasks: list, jobs: int) -> list:
    """``fn`` over ``tasks`` in order, in ``jobs`` spawned processes when
    more than one (each task in a process's own fake world)."""
    if jobs <= 1:
        return [fn(t) for t in tasks]
    with mp.get_context("spawn").Pool(jobs, maxtasksperchild=1) as pool:
        return pool.map(fn, tasks, chunksize=1)


#: One H100's memory: a cell whose predicted per-rank peak passes it does
#: not fit.
HBM_BYTES = 80e9


def table(results: list) -> str:
    """The records as a markdown table: per cell and mesh the status, the
    per-rank argument and peak GB (``>80`` past one H100), FLOPs, the
    collectives' count and operand GB, and the trace seconds."""
    lines = ["| cell | mesh | status | args GB | peak GB | FLOPs | collectives | coll GB | "
             "trace s |", "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        head = f"| {r['cell']} | {r.get('mesh_kind', '')} | {r['status']} |"
        if r["status"] != "ok" or "memory" not in r:
            lines.append(head + " | | | | | |")
            continue
        peak = r["peak_bytes"]
        lines.append(
            head + f" {r['memory']['argument_size_in_bytes'] / 1e9:.2f} | {peak / 1e9:.2f}"
            + (" >80" if peak > HBM_BYTES else "") + f" | {r['flops_per_device']:.3e} | "
            f"{r['n_collective_ops']} | {r['collectives']['total_operand_bytes'] / 1e9:.2f} | "
            f"{r['trace_s']:.1f} |")
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lingam", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--cost-mode", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the path traced: the card's (default) or the plain one")
    ap.add_argument("--rank", type=int, default=0, help="the rank this process plays")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    arch_names = configs.ARCH_NAMES if (args.all or not args.arch) else tuple(args.arch.split(","))
    shape_names = tuple(SHAPES) if (args.all or not args.shape) else tuple(args.shape.split(","))
    t0 = time.perf_counter()
    if args.lingam:
        results = [r for recs in _run(_lingam_kind, [(k, args.rank, args.device) for k in kinds],
                                      args.jobs) for r in recs]
    else:
        tasks = [(a, s, k, args.rank, args.device, args.cost_mode)
                 for k in kinds for a in arch_names for s in shape_names]
        results = _run(_arch_cell, tasks, args.jobs)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        suffix = "cost" if args.cost_mode else ("lingam" if args.lingam else "dryrun")
        tag = f"{args.arch or 'all'}_{args.shape or 'all'}_{args.mesh}_{suffix}".replace(
            ",", "-").replace("/", "-")
        path = os.path.join(args.out, f"{tag}.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {path}")
    print(table(results))
    n_fail = sum(1 for r in results if r["status"] == "fail")
    print(f"== {len(results)} cells, {n_fail} failures, {time.perf_counter() - t0:.1f} s ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

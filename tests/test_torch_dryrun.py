"""The production dry run of the port (``repro_torch.launch.dryrun``,
``launch.specs``) on the CPU: fake tensors over a fake process group,
held against real runs and against the JAX package.

* Collectives and argument bytes per rank: at (data, model) = (1, 2), (2,
  1), (2, 2), the smoke configs of granite-3-2b (dense), deepseek-v2-
  lite-16b (MLA and MoE) and zamba2-2.7b (SSM and the shared attention)
  run two training steps (float32 masters: ZeRO-1 on the plain specs, as
  ``launch.train`` trains, and FSDP as the train cell shards it, over
  ``data`` where it is > 1, each leaf gathered where it is read and its
  gradient reduce-scattered) and one decode step (after a real prefill,
  the caches split-KV) for real on spawned gloo ranks
  (``test_torch_tp.run_grid``) under a ``CollectiveLedger``; the dry run
  of the same steps, rank by rank in fake worlds of that grid, counts the
  same collectives (by op) and the same argument bytes, exactly, on the
  plain path and on the card's.
* Shard shapes: every leaf of this rank's parameters, caches and ZeRO-1
  moments in the dry run's cells at (2, 2) equals the JAX package's shard
  of its own specs (``lm.param_specs``, ``lm.cache_specs``,
  ``optimizer.opt_state_specs(zero1=True)``) on a (2, 2) mesh of 4 fake
  XLA devices (a subprocess), the reference's stack axis dropped (an odd
  group count, so that ZeRO-1 and FSDP pick the same dimension in both
  trees). The train cell's parameters and moments are the reference's
  FSDP shards (its train cell's ``zero1_specs(p_shapes, param_specs,
  mesh)``, and ``opt_state_specs`` over them), the decode cell's
  parameters its plain ones. One difference is stated, not held: an SSM
  layer's conv tail, whose channels the reference cuts evenly, while the
  port keeps each model rank's x channels and the whole B and C
  (``lm.local_caches``).
* FLOPs: a smoke training step's ``flops_per_device`` equals
  ``FlopCounterMode`` on the same step run for real; granite-3-2b's
  forward at full width lies within 5% of 2·N·T.
* The kernel wrappers' fake branch returns the plain versions' shapes and
  dtypes, and counts no launch.
* Skips: every (arch, shape) the JAX package's ``applicable`` skips is a
  ``skipped`` record with its reason.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.dist.sharding import (
    ShardingRules, batch_rows, local_shard, make_rules, with_fsdp)
from repro_torch.kernels import _fake
from repro_torch.kernels import covupdate as cu
from repro_torch.kernels import fused_score as fs
from repro_torch.kernels import pairwise_score as ps
from repro_torch.kernels import ssd_decode as sd
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.models import attention, lm, ssm
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainer import make_train_step
from repro_torch.utils.collectives import CollectiveLedger
from repro_torch.utils.tree import param_count, tree_flatten_with_names
from test_torch_tp import GRIDS, ROOT, grid_id, run_grid

ARCHS = ("granite-3-2b", "deepseek-v2-lite-16b", "zamba2-2.7b")
#: Layers of each smoke config in the shard-shape test: an odd group count.
ODD_LAYERS = {"granite-3-2b": 3, "deepseek-v2-lite-16b": 4, "zamba2-2.7b": 6}
B, S, NEW = 4, 16, 4
OPT = OptimizerConfig(lr=1e-3, warmup_steps=0)
NAMES = ("data", "model")


def cfg_of(arch: str):
    return configs.smoke(arch).with_overrides(dtype="float32")


def tokens_of(cfg) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))).long()


# ---------------------------------------------------------------------------
# the real steps on gloo ranks, and their dry runs
# ---------------------------------------------------------------------------


def job_counts(mesh, arch: str, cp: bool = False):
    """On this rank: a training step under ZeRO-1 on the plain specs (as
    ``launch.train`` trains) and one under FSDP (``with_fsdp``: over
    ``data`` where it is > 1, as the train cell builds it), then a decode
    step of ``arch``, each for real under a ledger: the collectives, by
    op, and the arguments' bytes. With ``cp`` the training steps and the
    prefill run under the ``cp_seq`` rules (context parallelism), the
    prefill under a ledger too, and the decode step under the plain ones,
    as the cells of ``REPRO_OPT=cp_seq`` run them."""
    cfg = cfg_of(arch)
    plain, rows = batch_rows(B, make_rules(cfg, mesh))
    tp_rules = plain
    if cp:
        plain = dataclasses.replace(plain, context_parallel=True, shard_heads=False)
    batch = {"tokens": local_shard(tokens_of(cfg), rows, plain)}
    out = {}
    for key, rules in (("train", plain), ("fsdp", with_fsdp(plain))):
        pspecs = lm.param_specs(cfg, rules)
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", rules=rules)
        opt = init_opt_state(params, pspecs, rules)
        step = make_train_step(lambda p, b, rules=rules: lm.train_loss(p, b, cfg, rules), OPT,
                               accum_steps=1, param_specs=pspecs, rules=rules)
        out[f"{key}_bytes"] = dryrun.argument_bytes((params, opt, batch))
        with CollectiveLedger() as ledger:
            step(params, opt, batch)
        out[f"{key}_calls"] = ledger.calls
        out[f"{key}_ops"] = ops_of(ledger.records)
    rules = tp_rules
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", rules=rules)
    with torch.no_grad():
        toks = batch["tokens"][:, :S]
        with CollectiveLedger() as ledger:
            _, caches = lm.prefill(params, toks, cfg, plain, max_seq=S + NEW)
        if cp:
            out["prefill_calls"] = ledger.calls
        tok = torch.zeros((toks.shape[0],), dtype=torch.int64)
        pos = torch.full((toks.shape[0],), S, dtype=torch.int64)
        out["decode_bytes"] = dryrun.argument_bytes((params, tok, caches, pos))
        with CollectiveLedger() as ledger:
            lm.decode_step(params, tok, caches, pos, cfg, rules)
        out["decode_calls"] = ledger.calls
    return out


def ops_of(records) -> dict:
    """A ledger's count of each op."""
    out: dict = {}
    for r in records:
        out[r["op"]] = out.get(r["op"], 0) + 1
    return out


#: (grid, arch) of the dry-against-real hold: every arch at every grid, and
#: granite at (1, 3), whose 4 smoke heads, MLP columns and vocabulary the
#: three model ranks split unevenly (deepseek's 4 experts and zamba2's SSM
#: heads do not split over 3).
COUNT_CASES = [(grid, arch) for grid in GRIDS for arch in ARCHS] + [((1, 3), "granite-3-2b")]
#: The cases run under ``REPRO_OPT=cp_seq`` as well (``job_counts(cp=True)``).
CP_CASES = [((1, 2), "granite-3-2b")]
CASES = [(g, a, False) for g, a in COUNT_CASES] + [(g, a, True) for g, a in CP_CASES]


def case_key(arch: str, cp: bool) -> str:
    return arch + ("-cp" if cp else "")


@functools.cache
def real_counts(grid, tmp: str) -> list:
    cases = [(arch, cp) for g, arch, cp in CASES if g == grid]
    return run_grid(grid, [(case_key(arch, cp), job_counts, {"arch": arch, "cp": cp})
                           for arch, cp in cases], os.path.join(tmp, grid_id(grid)))


def dry_counts(arch: str, grid, rank: int, device: str, cp: bool = False) -> dict:
    cfg = cfg_of(arch)
    out = {}
    saved = os.environ.pop("REPRO_OPT", None)
    if cp:
        os.environ["REPRO_OPT"] = "cp_seq"
    try:
        with fake_world(grid, NAMES, rank=rank) as mesh:
            out.update(_dry_cells(cfg, mesh, rank, device, cp))
    finally:
        os.environ.pop("REPRO_OPT", None)
        if saved is not None:
            os.environ["REPRO_OPT"] = saved
    return out


def _dry_cells(cfg, mesh, rank: int, device: str, cp: bool) -> dict:
    """``dry_counts``' cells, traced as ``rank`` of ``mesh``."""
    out = {}
    for key, fsdp in (("train", False), ("fsdp", True)):
        train = dryrun.trace_cell(
            specs.make_cell(cfg, ShapeSpec("t", "train", S, B), mesh, opt_cfg=OPT,
                            accum_steps=1, device=device, fsdp=fsdp),
            mesh, rank=rank, verbose=False)
        out[f"{key}_calls"] = train["n_collective_ops"]
        out[f"{key}_ops"] = {op: a["count"] for op, a in train["collectives"]["by_op"].items()}
        out[f"{key}_bytes"] = train["memory"]["argument_size_in_bytes"]
    if cp:
        prefill = dryrun.trace_cell(specs.make_cell(cfg, ShapeSpec("p", "prefill", S, B), mesh,
                                                    device=device, max_seq=S + NEW),
                                    mesh, rank=rank, verbose=False)
        out["prefill_calls"] = prefill["n_collective_ops"]
    decode = dryrun.trace_cell(specs.make_cell(cfg, ShapeSpec("d", "decode", S + NEW, B),
                                               mesh, device=device),
                               mesh, rank=rank, verbose=False)
    out["decode_calls"] = decode["n_collective_ops"]
    out["decode_bytes"] = decode["memory"]["argument_size_in_bytes"]
    return out


@pytest.fixture(scope="module")
def grid_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_grids"))


@pytest.mark.parametrize("grid,arch,cp", CASES,
                         ids=[f"{grid_id(g)}-{a}" + ("-cp" if cp else "") for g, a, cp in CASES])
def test_dry_run_counts_the_collectives_and_arguments_of_a_real_run(grid, arch, cp, grid_tmp):
    real = real_counts(grid, grid_tmp)
    for rank in range(math.prod(grid)):
        want = real[rank][case_key(arch, cp)]
        assert want["train_calls"] > 0 and (want["decode_calls"] > 0 or grid[1] == 1)
        # ZeRO-1 reduce-scatters nothing; FSDP's backward does where data > 1, and
        # context parallelism's gathers' backward wherever it runs
        assert ("reduce-scatter" in want["train_ops"]) == cp, want["train_ops"]
        assert ("reduce-scatter" in want["fsdp_ops"]) == (grid[0] > 1 or cp), want["fsdp_ops"]
        for device in ("cpu", "cuda"):
            assert dry_counts(arch, grid, rank, device, cp) == want, (grid, rank, device)


# ---------------------------------------------------------------------------
# shard shapes against the reference's specs
# ---------------------------------------------------------------------------

_REFERENCE_SHARDS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import functools, json
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro
from repro import configs
from repro.dist.sharding import make_rules
from repro.launch.mesh import make_local_mesh
from repro.models import lm
from repro.train.optimizer import opt_state_specs, zero1_specs


def named(tree, spec_tree, mesh):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for (path, leaf), spec in zip(leaves, spec_leaves):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = list(NamedSharding(mesh, spec).shard_shape(leaf.shape))
    return out


out = {}
mesh = make_local_mesh(2, 2)
for arch, layers in LAYERS.items():
    cfg = configs.smoke(arch).with_overrides(n_layers=layers, dtype="float32")
    rules = make_rules(cfg, mesh)
    p = jax.eval_shape(functools.partial(lm.init_params, cfg=cfg, dtype=jnp.float32),
                       jax.random.PRNGKey(0))
    pspecs = lm.param_specs(cfg)
    caches = jax.eval_shape(functools.partial(lm.init_cache, cfg, B, SEQ, jnp.float32))
    fsdp = zero1_specs(p, pspecs, mesh)  # the train cell's parameter specs
    out[arch] = {"params": named(p, pspecs, mesh),
                 "fsdp": named(p, fsdp, mesh),
                 "fsdp_m": named(p, opt_state_specs(p, fsdp, mesh, zero1=True)["m"], mesh),
                 "caches": named(caches, lm.cache_specs(cfg, rules), mesh)}
print(json.dumps(out))
"""


@functools.cache
def reference_shards() -> dict:
    """The reference's per-device shard shapes of every leaf on a (2, 2)
    mesh of 4 fake XLA devices (a subprocess: the device count is fixed
    before JAX starts)."""
    code = (f"LAYERS, B, SEQ = {ODD_LAYERS!r}, {B}, {S + NEW}\n"
            + textwrap.dedent(_REFERENCE_SHARDS))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _unstacked(name: str) -> tuple[str, bool]:
    """A port leaf's name in the reference's stacked tree, and whether the
    reference stacks it (a group's index dropped)."""
    parts = name.split("/")
    if parts[0] in ("groups", "enc_groups"):
        return "/".join(parts[:1] + parts[2:]), True
    return name, False


def _against(port: dict, ref: dict, skip=lambda name: False):
    """Each port leaf's shape against the reference's shard shape of its
    stacked leaf, the stack axis dropped."""
    seen = set()
    for name, shape in port.items():
        ref_name, stacked = _unstacked(name)
        if skip(ref_name):
            continue
        want = ref[ref_name][1:] if stacked else ref[ref_name]
        assert list(shape) == want, (name, list(shape), want)
        seen.add(ref_name)
    assert seen == {n for n in ref if not skip(n)}


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_equal_the_reference_specs_on_four_devices(arch):
    ref = reference_shards()[arch]
    cfg = cfg_of(arch).with_overrides(n_layers=ODD_LAYERS[arch])
    tail = lambda name: cfg.family in ("ssm", "hybrid") and name.endswith("/1") and (  # noqa: E731
        name.startswith("groups/pos") and _kind(cfg, name) == "ssm")
    for rank in range(4):
        with fake_world((2, 2), NAMES, rank=rank) as mesh:
            train = specs.make_cell(cfg, ShapeSpec("t", "train", S, B), mesh, accum_steps=1)
            decode = specs.make_cell(cfg, ShapeSpec("d", "decode", S + NEW, B), mesh)
        params, opt, _ = train.args
        leaves = lambda t: {n: tuple(x.shape) for n, x in tree_flatten_with_names(t)}  # noqa: E731
        assert train.rules.fsdp_axes == ("data",) and decode.rules.fsdp_axes == ()
        _against(leaves(params), ref["fsdp"])
        _against(leaves(opt["m"]), ref["fsdp_m"])
        _against(leaves(opt["v"]), ref["fsdp_m"])
        _against(leaves(decode.args[0]), ref["params"])
        _against(leaves(decode.args[2]), ref["caches"], skip=tail)
        # the stated difference: the conv tail keeps each rank's x channels
        # and the whole B and C
        for name, shape in leaves(decode.args[2]).items():
            ref_name, _ = _unstacked(name)
            if tail(ref_name):
                c = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
                assert ref["caches"][ref_name][-1] == c // 2
                assert shape[-1] == cfg.d_inner // 2 + 2 * cfg.ssm_ngroups * cfg.ssm_state


def _kind(cfg, name: str) -> str:
    return lm.group_layout(cfg)[int(name.split("/")[1][3:])]


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_of_a_smoke_step_equal_flop_counter_mode_on_the_real_step(arch):
    cfg = cfg_of(arch)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg), OPT)
    with FlopCounterMode(display=False) as counter:
        step(params, init_opt_state(params), {"tokens": tokens_of(cfg)})
    cell = specs.make_cell(cfg, ShapeSpec("t", "train", S, B), None, opt_cfg=OPT,
                           accum_steps=1, device="cpu")
    rec = dryrun.trace_cell(cell, None, verbose=False)
    assert counter.get_total_flops() > 0
    assert rec["flops_per_device"] == counter.get_total_flops()


def test_granite_forward_at_full_width_is_two_n_t():
    cfg = configs.get("granite-3-2b")
    mode = FakeTensorMode()
    params = specs.param_shapes(cfg, torch.bfloat16, ShardingRules(), mode)
    with mode:
        tokens = torch.zeros((2, 256), dtype=torch.int64)
    with torch.no_grad():
        _, tracer, _, _, _ = dryrun.run_traced(lambda p, t: lm.forward(p, t, cfg), (params, tokens),
                                               mode, stand_in=False)
    want = 2 * param_count(params) * tokens.numel()
    assert abs(tracer.flops / want - 1) < 0.05, (tracer.flops, want)


def test_card_path_counts_the_decode_kernel_and_its_flops():
    cfg = cfg_of("zamba2-2.7b")
    shape = ShapeSpec("d", "decode", S + NEW, B)
    card = dryrun.trace_cell(specs.make_cell(cfg, shape, None), None, verbose=False)
    plain = dryrun.trace_cell(specs.make_cell(cfg, shape, None, device="cpu"), None,
                              verbose=False)
    ssm_layers = cfg.n_groups * cfg.hybrid_attn_every
    assert card["kernels"] == {"ssd_decode": ssm_layers} and plain["kernels"] == {}
    assert card["memory"]["argument_size_in_bytes"] == plain["memory"]["argument_size_in_bytes"]
    assert card["flops_per_device"] > 0 and sd.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the tracer's storage accounting
# ---------------------------------------------------------------------------


def test_tracer_counts_each_storage_once_and_frees_it():
    mode = FakeTensorMode()
    with mode:
        known = torch.empty(256)

    def fn(x):
        a = torch.empty(1000)  # +4000
        v = a.view(10, 100)  # a view: nothing new
        a.add_(1)  # in place: nothing new
        b = x * 2  # +1024
        del a, v
        c = torch.empty(10)  # after a's 4000 left: +40
        return b, c, x.view(16, 16)

    out, tracer, _, _, _ = dryrun.run_traced(fn, (known,), mode, stand_in=False)
    assert tracer.peak == 4000 + 1024
    assert tracer.peak_by_op == {"empty": 4000, "mul": 1024}
    assert tracer.total == 1024 + 40
    rec = dryrun.record("x", None, (known,), out, tracer, [], [], 0.0, rank=0, device="cpu",
                        traced_on="cpu")
    assert rec["memory"]["argument_size_in_bytes"] == 1024
    assert rec["temp_by_op_at_peak"] == {"empty": 4000, "mul": 1024}
    assert rec["memory"]["output_size_in_bytes"] == 1024 + 40 + 1024
    assert rec["memory"]["alias_size_in_bytes"] == 1024
    # the in-place add read and wrote a, the product x and b; allocations none
    assert rec["bytes_per_device"] == 2 * 4000 + 2 * 1024


# ---------------------------------------------------------------------------
# the kernel wrappers' fake branch
# ---------------------------------------------------------------------------


def _wrapper_calls(dev_tensors):
    """Each wrapper called on tensors from ``dev_tensors(shape, dtype)``:
    its outputs (a tuple each)."""
    t = dev_tensors
    xn, c, m = t((13, 70), torch.float32), t((13, 13), torch.float32), t((13,), torch.bool)
    xb, cb, mb = t((3, 13, 70), torch.float32), t((3, 13, 13), torch.float32), \
        t((3, 13), torch.bool)
    roots = torch.zeros((3,), dtype=torch.int64, device=xb.device)
    state = t((2, 4, 8, 6), torch.float32)
    return {
        "fused_score": (fs.fused_score_vector(xn, c, m),),
        "fused_score_batch": (fs.fused_score_batch(xb, cb, mb),),
        "pairwise_moments": ps.pairwise_moments(xn, xn, c, live_i=m, live_j=m),
        "pairwise_moments_batch": ps.pairwise_moments_batch(xb, cb, mask=mb),
        "update_data": (cu.update_data(xn, t((70,), torch.float32), t((13,), torch.float32)),),
        "update_cov": (cu.update_cov(c, t((13,), torch.float32)),),
        "rank1_update": cu.rank1_update(xb, cb, roots, mb),
        "rank1_update_inplace": cu.rank1_update(xb, cb, roots, mb, inplace=True) + (xb,),
        "ssd_decode": sd.ssd_decode(state, t((2, 4, 8), torch.float32), t((2, 4), torch.float32),
                                    t((2, 6), torch.float32), t((2, 6), torch.float32),
                                    t((4,), torch.float32), t((4,), torch.float32)),
    }


def test_kernel_wrappers_fake_branch_returns_the_plain_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)

    def real(shape, dtype):
        return torch.ones(shape, dtype=dtype) if dtype == torch.bool else \
            torch.rand(shape, generator=gen, dtype=dtype)

    want = _wrapper_calls(real)
    launches = (fs.LAUNCHES, fs.BATCH_LAUNCHES, ps.LAUNCHES, ps.BATCH_LAUNCHES, cu.RANK1_LAUNCHES,
                cu.DATA_LAUNCHES, cu.COV_LAUNCHES, sd.LAUNCHES)
    with FakeTensorMode(), _fake.stand_in(), _fake.recording() as calls:
        got = _wrapper_calls(lambda shape, dtype: torch.empty(shape, dtype=dtype))
    for name in want:
        assert [(tuple(x.shape), x.dtype) for x in got[name]] == \
            [(tuple(x.shape), x.dtype) for x in want[name]], name
    x_out, _, xb = got["rank1_update_inplace"]
    assert x_out is xb and got["rank1_update"][0] is not xb
    assert [n for n, _ in calls] == ["fused_score", "fused_score_batch", "pairwise_moments",
                                     "pairwise_moments_batch", "update_data", "update_cov",
                                     "rank1_update", "rank1_update", "ssd_decode"]
    assert all(f > 0 for _, f in calls)
    assert calls[0][1] == fs.flops(13, 70) and calls[-1][1] == sd.flops(2, 4, 8, 6)
    assert (fs.LAUNCHES, fs.BATCH_LAUNCHES, ps.LAUNCHES, ps.BATCH_LAUNCHES, cu.RANK1_LAUNCHES,
            cu.DATA_LAUNCHES, cu.COV_LAUNCHES, sd.LAUNCHES) == launches
    # without the stand-in a fake CPU tensor takes the plain path: no note
    with FakeTensorMode(), _fake.recording() as calls:
        _wrapper_calls(lambda shape, dtype: torch.empty(shape, dtype=dtype))
    assert calls == []


# ---------------------------------------------------------------------------
# skips, options and the command line
# ---------------------------------------------------------------------------


def test_dry_run_skips_what_the_reference_skips():
    from repro import configs as j_configs
    from repro.configs.shapes import SHAPES as J_SHAPES
    from repro.configs.shapes import applicable as j_applicable

    assert tuple(SHAPES) == tuple(J_SHAPES) and configs.ARCH_NAMES == j_configs.ARCH_NAMES
    skipped = 0
    for arch in configs.ARCH_NAMES:
        for name in SHAPES:
            ok, reason = j_applicable(j_configs.get(arch), J_SHAPES[name])
            assert dataclasses.astuple(SHAPES[name]) == dataclasses.astuple(J_SHAPES[name])
            if ok:
                continue
            rec = dryrun._arch_cell((arch, name, "single", 0, "cuda", False))
            assert rec == {"cell": f"{arch}/{name}", "mesh_kind": "single", "status": "skipped",
                           "reason": reason}
            skipped += 1
    assert skipped == 8  # long_500k of every family but ssm and hybrid


def test_cp_seq_is_unsupported_and_kv_int8_runs(monkeypatch):
    """``cp_seq`` builds the train cell under context parallelism (an
    ``ok`` record that says so, every head on the rank, the train cell's
    FSDP), and ``kv_int8`` still decodes over the int8 cache."""
    monkeypatch.setenv("REPRO_OPT", "cp_seq,kv_int8")
    cfg = cfg_of("granite-3-2b")
    with fake_world((2, 2), NAMES) as mesh:
        cell = specs.make_cell(cfg, ShapeSpec("t", "train", S, B), mesh, opt_cfg=OPT,
                               accum_steps=1)
        rec = dryrun.trace_cell(cell, mesh, verbose=False)
    assert rec["status"] == "ok" and rec["context_parallel"] is True
    assert cell.rules.context_parallel and not cell.rules.shard_heads
    assert rec["fsdp_axes"] == ["data"] and rec["head_block"] == [0, cfg.n_heads]
    with fake_world((2, 2), NAMES) as mesh:
        cell = specs.make_cell(cfg, ShapeSpec("d", "decode", S + NEW, B), mesh)
        rec = dryrun.trace_cell(cell, mesh, verbose=False)
    k_cache = cell.args[2]["groups"][0]["pos0"][0]
    assert k_cache.dtype == torch.int8 and rec["status"] == "ok"


def test_heads_the_model_ranks_do_not_split_are_unsupported():
    """The attention's heads split over any number of model ranks, in
    balanced blocks (yi-34b's 56, llama4's 40 and whisper's 8 over 16);
    SSM heads must split evenly: the real path raises in
    ``ssm.ssm_head_block`` and the dry run records such a cell as
    unsupported with that reason (mamba2's 32 and zamba2's 80 over 3)."""
    with fake_world((16, 16), NAMES) as mesh:
        for arch, heads in (("yi-34b", 56), ("llama4-scout-17b-a16e", 40), ("whisper-base", 8),
                            ("granite-3-2b", 32), ("zamba2-2.7b", 32), ("mamba2-370m", 0)):
            cfg = configs.get(arch)
            rules = make_rules(cfg, mesh)
            assert rules.model_axis == "model", arch
            specs.check_heads(cfg, rules)
            if heads:
                lo, hi = attention.head_block(cfg.n_heads, rules)
                assert (lo, hi) == (0, -(-heads // 16)), arch
    with fake_world((1, 3), NAMES) as mesh:
        for arch, heads in (("mamba2-370m", 32), ("zamba2-2.7b", 80)):
            cfg = configs.get(arch)
            rules = make_rules(cfg, mesh)
            with pytest.raises(ValueError, match=f"{heads} SSM heads do not split over 3"):
                ssm.ssm_head_block(cfg, rules)
            rec = dryrun.cell_record(cfg, SHAPES["decode_32k"], mesh, rank=0, device="cuda",
                                     verbose=False)
            assert rec["status"] == "unsupported", arch
            assert rec["reason"] == f"{heads} SSM heads do not split over 3 model ranks"


def test_cost_mode_extrapolates_to_the_full_depth(capsys):
    cfg = cfg_of("granite-3-2b").with_overrides(n_layers=4)
    shape = ShapeSpec("d", "decode", S + NEW, B)
    with fake_world((2, 2), NAMES) as mesh:
        full = dryrun.trace_cell(specs.make_cell(cfg, shape, mesh), mesh, verbose=False)
        est = dryrun.cost_mode_cell(cfg, shape, mesh)
    assert est["cost_mode"] == "delta_1_2"
    assert est["flops_per_device"] == pytest.approx(full["flops_per_device"], rel=1e-12)
    assert est["n_collective_ops"] == full["n_collective_ops"]
    assert est["collectives"]["total_wire_bytes"] == \
        pytest.approx(full["collectives"]["total_wire_bytes"], rel=1e-12)


def test_lingam_cells_trace_every_step(monkeypatch):
    monkeypatch.setattr(configs, "LINGAM_CONFIGS",
                        {k: v for k, v in configs.LINGAM_CONFIGS.items() if "ecoli" in k})
    with fake_world((2, 2), NAMES) as mesh:
        recs = {r["cell"].split("/")[1]: r for r in dryrun.lingam_cells(mesh)}
    assert all(r["status"] == "ok" and r["p_bucket"] == 128 for r in recs.values())
    assert recs["find_root_fused"]["kernels"] == {"fused_score": 1}
    assert recs["find_root_fused"]["flops_per_device"] == fs.flops(128, 10000)
    assert recs["update"]["kernels"] == {"rank1_update": 1}
    ring = recs["find_root_ring"]
    assert ring["kernels"]["pairwise_moments"] >= 2 and ring["n_collective_ops"] > 0
    assert "collective-permute" in ring["collectives"]["by_op"]


def test_command_line_writes_the_reference_file_names(tmp_path):
    rc = dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k,long_500k", "--mesh",
                      "single", "--out", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "mamba2-370m_decode_32k-long_500k_single_dryrun.json") as f:
        recs = json.load(f)
    assert [r["status"] for r in recs] == ["ok", "ok"]
    rec = recs[0]
    assert rec["mesh"] == "16x16" and rec["mesh_kind"] == "single" and rec["fsdp_axes"] == []
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "alias_size_in_bytes",
                                  "generated_code_size_in_bytes"}
    assert rec["kernels"] == {"ssd_decode": 48}
    assert rec["peak_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("multi", (False, True), ids=("16x16", "2x16x16"))
def test_train_records_carry_the_reference_fsdp_axes(multi):
    """A train cell on the production meshes shards its parameters and
    moments over ``data`` (FSDP, ``["data"]`` on 16 × 16 and ``["pod",
    "data"]`` on 2 × 16 × 16, the pods replicating them as the reference's
    ``zero1_specs`` default leaves them): every leaf of granite-3-2b cut to
    one layer divides by 16 data ranks, so the parameters' and moments'
    bytes are 1/16 of the same cell's without FSDP, and the backward's
    reduce-scatters are on the ledger. A prefill record keeps ``[]``."""
    cfg = configs.get("granite-3-2b").with_overrides(n_layers=1)
    with fake_world(*production_shape(multi), rank=0) as mesh:
        cell = specs.make_cell(cfg, ShapeSpec("t", "train", 16, 64), mesh, accum_steps=1)
        rec = dryrun.trace_cell(cell, mesh, verbose=False)
        pre = dryrun.trace_cell(specs.make_cell(cfg, ShapeSpec("p", "prefill", 16, 64), mesh),
                                mesh, verbose=False)
        plain = dataclasses.replace(cell.rules, fsdp_axes=())
        with cell.mode:
            whole = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", rules=plain)
    assert rec["fsdp_axes"] == (["pod", "data"] if multi else ["data"])
    assert pre["fsdp_axes"] == []
    assert "reduce-scatter" in rec["collectives"]["by_op"]
    params, opt, _ = cell.args
    state = dryrun.argument_bytes((params, opt["m"], opt["v"]))
    assert state * 16 == 3 * dryrun.argument_bytes(whole)
    assert rec["memory"]["argument_size_in_bytes"] == dryrun.argument_bytes(cell.args)

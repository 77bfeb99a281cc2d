"""FSDP in ``repro_torch`` on the CPU: the training leaves sharded over the
data ranks as well as over ``model`` (``dist.sharding.fsdp_specs``: the
reference's ``zero1_specs`` with ``data_axes=("data",)``), gathered where
the model reads them and their gradients reduce-scattered
(``gather_at_use``), the moments each leaf's own shard, on spawned gloo
ranks held against the same grid without FSDP, the port's one-rank run
and the JAX package's FSDP train step.

Grids ``(data, model)`` = (2, 2) and (2, 1), one spawn of D × M ranks per
grid running every case (``test_torch_tp.run_grid``), the FSDP rules built
as the reference's ``launch/specs.py:103-110`` builds them
(``dist.sharding.with_fsdp``: ``fsdp_axes=("data",)``). The smoke configs
of granite-3-2b (dense, tied embeddings), llama4-scout-17b-a16e (MoE with
a shared expert), deepseek-v2-lite-16b (MLA, MoE, a dense prologue) and
zamba2-2.7b (the shared block, ``w_zx`` cut part by part over ``model``
and plainly over ``data``) run in float32 on the reference's weights, B=8
× 64 tokens (``test_torch_tp``'s inputs). What is held:

* the loss equal, bit for bit, to the same grid's loss without FSDP (the
  gathered leaves are the leaves, and the forward runs the same ops);
* under the bfloat16 compute cast (``make_train_step``'s default, which
  FSDP applies before its gather), the loss equal bit for bit to the
  same grid's without FSDP, and every averaged gradient too, but a leaf's
  that the model reads more than once: there the path without FSDP sums
  the uses' gradients in bfloat16, and the two lie within bfloat16's
  rounding (2^-8 of the leaf's norm);
* the loss and every leaf's gradient gathered from the ranks against the
  port's one-rank run (``test_torch_tp.baseline``: at (2, 2) a MoE config
  routes each batch shard alone, ``local_capacity``), the loss within rtol
  1e-5 and each gradient within 1e-5 of its one-rank norm;
* one ``make_train_step``: ``m`` and ``v`` gathered within 1e-5 of each
  leaf's one-rank norm, the parameters too, with ``ROUNDING_LEVEL_ARCHS``
  treated as ``test_torch_tp.py`` treats them; ``adamw_update`` on this
  rank's shards of the one-rank gradients within 1e-5 of the one-rank
  update;
* every rank's parameter, ``m`` and ``v`` shard shaped as ``local_shard``
  cuts its full leaf under the FSDP spec, ``lm.param_specs(cfg, rules)``
  equal to ``fsdp_specs`` of the full shapes, ``adamw_update`` gathering
  nothing (no ``all-gather`` in its ``CollectiveLedger``: an FSDP leaf
  updates in place), and the backward's reduce-scatters on the gloo
  ranks' ledger by its operand and wire conventions;
* the loss and one step's parameters and ``m`` against the JAX package's
  float32 FSDP step (``zero1_specs`` parameter specs, ``fsdp_axes``,
  jitted in a subprocess on fake XLA devices: (2, 2) on 4 devices for
  every config, and (2, 1) on 2 of them for the MoE configs, whose (2, 1)
  routing is global and so departs from (2, 2)'s; granite and zamba2 at
  (2, 1) are held against the (2, 2) step, the same arithmetic): the loss
  within rtol 1e-5, ``m`` within 1e-4 of each leaf's norm (the two
  packages' gradients, ``tests/test_torch_train.py``'s float32 tolerance),
  and each parameter as ``test_train_step_float32_matches_reference``
  holds it: within 1e-3 · lr of the reference's where its ``m`` is not at
  rounding level, within the step's reach 2 · lr where it is, at most one
  weight in 1000 of those moved beyond 1e-3 · lr;
* a checkpoint of zamba2 saved at (2, 2) under FSDP after two steps
  restores on one rank and on (2, 1) (under FSDP there) to the same full
  leaves, bit for bit.
"""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_tp as tp
from repro_torch import configs
from repro_torch.dist.sharding import (
    P,
    average_over_batch_,
    fsdp_specs,
    gather_tree,
    local_shard,
    make_rules,
    shard_tree,
    split_parts,
    with_fsdp,
)
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (
    adamw_update,
    init_opt_state,
    opt_state_specs,
    zero1_layout,
)
from repro_torch.train.trainer import loss_and_grads, make_train_step, state_specs
from repro_torch.utils.collectives import CollectiveLedger
from repro_torch.utils.tree import (
    param_count,
    tree_flatten_with_names,
    tree_leaves,
    tree_unflatten,
)

ARCHS = ("granite-3-2b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b", "zamba2-2.7b")
#: (2, 2) runs first: it saves the checkpoint that (2, 1) restores.
GRIDS = ((2, 2), (2, 1))
#: The JAX package's FSDP step is jitted at each grid for these configs.
REFERENCE_GRIDS = {(2, 2): ARCHS,
                   (2, 1): tuple(a for a in ARCHS if configs.smoke(a).is_moe)}
OPT = tp.OPT
TOL = 1e-5
#: ``m`` against the JAX package's: the two packages' float32 gradients.
REFERENCE_M_TOL = 1e-4
CKPT_ARCH = "zamba2-2.7b"
#: A gradient under the bfloat16 cast of a leaf the model reads more than
#: once (granite's tied embedding, zamba2's shared block) against the path
#: without FSDP, of its norm: that path sums the uses' bfloat16 gradients
#: in bfloat16, FSDP each use's reduce-scattered slice in float32.
BF16_ROUNDING = 2.0 ** -8


# ---------------------------------------------------------------------------
# rank jobs
# ---------------------------------------------------------------------------


def job_fsdp(mesh, arch: str, leaves: dict, batch: dict, given: list):
    """On this rank: the same grid's loss without FSDP; under FSDP the loss
    and its gradients (gathered), one ``make_train_step`` (the state
    gathered), ``adamw_update`` on this rank's shards of the one-rank
    gradients ``given`` under a ledger, and every shard's shape beside the
    one its FSDP spec cuts."""
    cfg = configs.smoke(arch)
    plain = make_rules(cfg, mesh)
    rules = with_fsdp(plain)
    specs = lm.param_specs(cfg)
    full = tp.full_params(cfg, leaves)
    fspecs = fsdp_specs(full, specs, rules)
    rows = P(tuple(rules.batch_axes))
    batch = {k: local_shard(v, rows, rules) for k, v in tp.torch_batch(batch).items()}
    plain_loss, _ = loss_and_grads(lambda p, b: lm.train_loss(p, b, cfg, plain),
                                   shard_tree(full, specs, plain), batch, cast_bf16=False)
    fn = lambda p, b: lm.train_loss(p, b, cfg, rules)  # noqa: E731
    params = shard_tree(tp.full_params(cfg, leaves), fspecs, rules)
    with CollectiveLedger() as ledger:
        loss, grads = loss_and_grads(fn, params, batch, False, fspecs, rules)
    average_over_batch_(grads, rules, fspecs)
    out = {"loss": float(loss), "plain_loss": float(plain_loss),
           "cast": cast_against_plain(cfg, full, batch, specs, fspecs, plain, rules),
           "reduce_scatters": [r for r in ledger.records if r["op"] == "reduce-scatter"],
           "specs_equal": lm.param_specs(cfg, rules) == fspecs,
           "grads": tp._numpy(gather_tree(tree_unflatten(params, grads), fspecs, rules))}

    params = shard_tree(tp.full_params(cfg, leaves), fspecs, rules)
    opt_state = init_opt_state(params, fspecs, rules)
    out["want_shapes"] = [tuple(local_shard(t, s, rules, split_parts(name)).shape) for
                          (name, t), s in zip(tree_flatten_with_names(full), tree_leaves(fspecs))]
    out["shapes"] = {k: [tuple(t.shape) for t in tree_leaves(tree)] for k, tree in
                     (("params", params), ("m", opt_state["m"]), ("v", opt_state["v"]))}
    out["fsdp_leaves"] = sum(s != f for s, f in zip(tree_leaves(specs), tree_leaves(fspecs)))
    out["zero1_slices"] = sum(z is not None for z in zero1_layout(params, fspecs, rules))
    step = make_train_step(fn, OPT, cast_bf16=False, param_specs=fspecs, rules=rules)
    params, opt_state, metrics = step(params, opt_state, batch)
    moment_specs = opt_state_specs(params, fspecs, mesh)["m"]
    out["step_loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["params"] = tp._numpy(gather_tree(params, fspecs, rules))
    for k in ("m", "v"):
        out[k] = tp._numpy(gather_tree(opt_state[k], moment_specs, rules))

    params = shard_tree(tp.full_params(cfg, leaves), fspecs, rules)
    shards = shard_tree(tree_unflatten(params, [torch.from_numpy(g) for g in given]), fspecs,
                        rules)
    with torch.no_grad(), CollectiveLedger() as ledger:
        adamw_update(OPT, params, shards, init_opt_state(params, fspecs, rules), specs=fspecs,
                     rules=rules)
    out["adamw_ops"] = sorted({r["op"] for r in ledger.records})
    out["params_given"] = tp._numpy(gather_tree(params, fspecs, rules))
    keep = ("loss", "plain_loss", "cast", "specs_equal", "want_shapes", "shapes", "adamw_ops",
            "reduce_scatters")
    return out if dist.get_rank() == 0 else {k: out[k] for k in keep}


def cast_against_plain(cfg, full, batch, specs, fspecs, plain, rules) -> dict:
    """Under the bfloat16 compute cast (``make_train_step``'s default),
    the same grid's loss without FSDP and with it (each rank's), and on
    rank 0 each leaf's averaged gradient, gathered, as
    ``||fsdp - plain|| / ||plain||``, by name."""
    out, gathered = {}, {}
    for key, r, s in (("plain", plain, specs), ("fsdp", rules, fspecs)):
        params = shard_tree(full, s, r)
        loss, grads = loss_and_grads(lambda p, b, r=r: lm.train_loss(p, b, cfg, r), params,
                                     batch, True, s, r)
        average_over_batch_(grads, r, s)
        out[f"{key}_loss"] = float(loss)
        gathered[key] = tp._numpy(gather_tree(tree_unflatten(params, grads), s, r))
    out["grad_ratios"] = {
        name: float(np.linalg.norm(f.astype(np.float64) - g) / max(np.linalg.norm(g), 1e-30))
        for (name, _), f, g in zip(tree_flatten_with_names(full), gathered["fsdp"],
                                   gathered["plain"])}
    return out


def _ckpt_state(mesh):
    cfg = configs.smoke(CKPT_ARCH)
    rules = with_fsdp(make_rules(cfg, mesh))
    fspecs = lm.param_specs(cfg, rules)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", rules=rules)
    state = {"params": params, "opt": init_opt_state(params, fspecs, rules)}
    return cfg, rules, fspecs, state


def job_ckpt_save(mesh, ckpt_dir: str):
    """Two FSDP training steps, then a checkpoint of step 2; the state
    gathered (rank 0)."""
    cfg, rules, fspecs, state = _ckpt_state(mesh)
    step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg, rules), OPT, param_specs=fspecs,
                           rules=rules)
    rows = P(tuple(rules.batch_axes))
    for _ in range(2):
        batch = {k: local_shard(v, rows, rules) for k, v in tp._dp_batch(cfg).items()}
        step(state["params"], state["opt"], batch)
    specs = state_specs(state["params"], fspecs, rules)
    ckpt_lib.save(ckpt_dir, 2, state, specs=specs, rules=rules, block=True)
    full = tp._numpy(gather_tree(state, specs, rules))
    return full if dist.get_rank() == 0 else None


def job_ckpt_restore(mesh, ckpt_dir: str):
    """The checkpoint of step 2 restored on this mesh under FSDP (this
    rank's shards), gathered (rank 0)."""
    _, rules, fspecs, like = _ckpt_state(mesh)
    specs = state_specs(like["params"], fspecs, rules)
    got = ckpt_lib.restore(ckpt_dir, 2, like, device="cpu", specs=specs, rules=rules)
    shapes = [(tuple(a.shape), tuple(b.shape)) for a, b in zip(tree_leaves(got), tree_leaves(like))]
    assert all(a == b for a, b in shapes), shapes
    full = tp._numpy(gather_tree(got, specs, rules))
    return full if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# the reference's FSDP step (subprocesses on fake XLA devices)
# ---------------------------------------------------------------------------

_REFERENCE_STEP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
from dataclasses import replace
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP
from repro import configs
from repro.dist.sharding import make_rules
from repro.models import lm
from repro.train.optimizer import OptimizerConfig, init_opt_state, opt_state_specs, zero1_specs
from repro.train.trainer import make_train_step
from repro_torch import configs as t_configs
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_flatten_with_names

mesh = jax.make_mesh(GRID, ("data", "model"), devices=jax.devices()[:GRID[0] * GRID[1]],
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in ARCHS:
    cfg = configs.smoke(arch)
    p = jax.jit(lambda k: lm.init_params(k, cfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    pspecs = zero1_specs(p, lm.param_specs(cfg), mesh)  # the train cell's, specs.py:92-110
    ospecs = opt_state_specs(p, pspecs, mesh, zero1=True)
    rules = replace(make_rules(cfg, mesh), fsdp_axes=("data",))
    put = lambda tree, specs: jax.tree.map(lambda s, x: jax.device_put(x, NamedSharding(mesh, s)),
                                           specs, tree, is_leaf=lambda v: isinstance(v, JP))
    opt = init_opt_state(p)
    opt = {"m": put(opt["m"], ospecs["m"]), "v": put(opt["v"], ospecs["v"]), "step": opt["step"]}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, JP("data")))}
    step = make_train_step(lambda q, b: lm.train_loss(q, b, cfg, rules),
                           OptimizerConfig(lr=LR, warmup_steps=0), cast_bf16=False,
                           param_specs=pspecs)
    with jax.set_mesh(mesh):
        p1, s1, metrics = jax.jit(step)(put(p, pspecs), opt, batch)
    out[arch + "|loss"] = np.float64(metrics["loss"])
    for kind, tree in (("params", p1), ("m", s1["m"])):
        port = params_from_numpy(jax.tree.map(np.asarray, tree), t_configs.smoke(arch),
                                 device="cpu")
        for name, t in tree_flatten_with_names(port):
            out[arch + "|" + kind + "|" + name] = t.numpy()
np.savez(OUT, **out)
"""


def start_reference(grid, archs, path):
    """The JAX package's FSDP step of ``archs`` on a ``grid`` mesh of fake
    XLA devices, in a subprocess writing ``path`` (``np.savez``)."""
    code = (f"GRID, ARCHS, B, S, LR, OUT = {grid!r}, {archs!r}, {tp.B}, {tp.S}, {OPT.lr!r}, "
            f"{str(path)!r}\n" + textwrap.dedent(_REFERENCE_STEP))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=tp.ROOT)


def reference_step(proc, path) -> dict:
    """``{arch: {"loss", "params": {name: array}, "m": {...}}}`` of a
    ``start_reference`` subprocess."""
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            arch, kind, *name = key.split("|")
            entry = out.setdefault(arch, {"params": {}, "m": {}})
            if kind == "loss":
                entry["loss"] = float(data[key])
            else:
                entry[kind][name[0]] = data[key]
    return out


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every grid's rank results and the reference's steps: ``{"grids":
    {grid: [rank dicts]}, "reference": {grid: {arch: ...}}, "ckpt": dir}``."""
    tmp = tmp_path_factory.mktemp("fsdp")
    procs = {grid: (start_reference(grid, archs, tmp / f"ref{tp.grid_id(grid)}.npz"),
                    tmp / f"ref{tp.grid_id(grid)}.npz")
             for grid, archs in REFERENCE_GRIDS.items()}
    ckpt = str(tmp / "ckpt")
    try:
        grids = {}
        for grid in GRIDS:
            jobs = [(arch, job_fsdp, {"arch": arch, "leaves": tp.reference_model(arch)[0],
                                      "batch": tp.reference_model(arch)[1],
                                      "given": tp.baseline(arch, grid)["grads"]})
                    for arch in ARCHS]
            jobs.append(("ckpt", job_ckpt_save if grid == (2, 2) else job_ckpt_restore,
                         {"ckpt_dir": ckpt}))
            grids[grid] = tp.run_grid(grid, jobs, tmp / f"grid{tp.grid_id(grid)}")
        reference = {grid: reference_step(*pair) for grid, pair in procs.items()}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    return {"grids": grids, "reference": reference, "ckpt": ckpt}


def _hold_norm(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.astype(np.float64)
        diff = float(np.linalg.norm(g.astype(np.float64) - w))
        assert diff <= tol * float(np.linalg.norm(w)) + 1e-30, (what, i, diff,
                                                                float(np.linalg.norm(w)))


def _names(arch) -> list:
    return [name for name, _ in tree_flatten_with_names(lm.param_specs(configs.smoke(arch)))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=tp.grid_id)
def test_fsdp_loss_equals_the_grid_without_fsdp(runs, grid, arch):
    ranks = runs["grids"][grid]
    losses = [r[arch]["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses  # every rank holds the global loss
    for r in ranks:
        assert r[arch]["loss"] == r[arch]["plain_loss"], (r[arch]["loss"], r[arch]["plain_loss"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=tp.grid_id)
def test_fsdp_under_the_bf16_cast_equals_the_grid_without_fsdp(runs, grid, arch):
    ranks = runs["grids"][grid]
    for r in ranks:
        cast = r[arch]["cast"]
        assert cast["fsdp_loss"] == cast["plain_loss"], cast
    cfg = configs.smoke(arch)
    ratios = ranks[0][arch]["cast"]["grad_ratios"]
    reused = {n for n in ratios if n.startswith("shared/")
              or (n == "embed/tok" and cfg.tie_embeddings)}
    for name, ratio in ratios.items():
        if name in reused:
            assert ratio <= BF16_ROUNDING, (name, ratio)
        else:
            assert ratio == 0.0, (name, ratio)
    assert reused or not (cfg.tie_embeddings or cfg.family == "hybrid")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=tp.grid_id)
def test_fsdp_gradients_equal_one_rank(runs, grid, arch):
    got, want = runs["grids"][grid][0][arch], tp.baseline(arch, grid)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    assert [g.shape for g in got["grads"]] == [w.shape for w in want["grads"]]
    _hold_norm(got["grads"], want["grads"], TOL, "grad")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=tp.grid_id)
def test_fsdp_train_step_equals_one_rank(runs, grid, arch):
    got, want = runs["grids"][grid][0][arch], tp.baseline(arch, grid)
    np.testing.assert_allclose(got["step_loss"], want["step_loss"], rtol=TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=TOL)
    for k in ("m", "v"):
        _hold_norm(got[k], want[k], TOL, k)
    _hold_norm(got["params_given"], want["params"], TOL, "params_given")
    if arch not in tp.ROUNDING_LEVEL_ARCHS:
        _hold_norm(got["params"], want["params"], TOL, "params")
        return
    for i, (p, w, g) in enumerate(zip(got["params"], want["params"], want["grads"])):
        diff = np.abs(p.astype(np.float64) - w.astype(np.float64))
        level = np.abs(g) <= tp.ROUNDING_G * float(np.abs(g).max())
        assert float(diff[level].max(initial=0.0)) <= 2 * OPT.lr, ("params", i)
        norm = float(np.linalg.norm(np.where(level, 0.0, diff)))
        assert norm <= TOL * float(np.linalg.norm(w.astype(np.float64))) + 1e-30, \
            ("params", i, norm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=tp.grid_id)
def test_fsdp_shards_are_the_fsdp_specs_and_update_in_place(runs, grid, arch):
    ranks = runs["grids"][grid]
    r0 = ranks[0][arch]
    assert r0["fsdp_leaves"] > 0 and r0["zero1_slices"] == 0
    for rank, r in enumerate(ranks):
        got = r[arch]
        assert got["specs_equal"], rank
        assert got["shapes"]["params"] == got["want_shapes"], rank
        assert got["shapes"]["m"] == got["shapes"]["v"] == got["shapes"]["params"], rank
        # the norm's all-reduces only: no leaf is gathered after its update
        assert got["adamw_ops"] == ["all-reduce"], (rank, got["adamw_ops"])
        # the backward's reduce-scatters over the 2 data ranks, on the
        # ledger by its conventions (utils/collectives.py): the operand is
        # twice the result, the wire once
        rs = got["reduce_scatters"]
        assert len(rs) >= r0["fsdp_leaves"], (rank, len(rs))
        for rec in rs:
            assert rec["group_size"] == 2 and rec["operand_bytes"] == 2 * rec["out_bytes"]
            assert rec["wire_bytes"] == rec["out_bytes"]
    # the data ranks hold halves: the shards' elements sum to the model
    # ranks' share of the full tree
    full = param_count(tp.full_params(configs.smoke(arch), tp.reference_model(arch)[0]))
    assert sum(math.prod(s) for s in r0["shapes"]["params"]) < full / grid[1]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=tp.grid_id)
def test_fsdp_step_matches_the_reference(runs, grid, arch):
    got = runs["grids"][grid][0][arch]
    ref_grid = grid if arch in REFERENCE_GRIDS[grid] else (2, 2)
    want = runs["reference"][ref_grid][arch]
    np.testing.assert_allclose(got["step_loss"], want["loss"], rtol=TOL)
    names = _names(arch)
    _hold_norm(got["m"], [want["m"][n] for n in names], REFERENCE_M_TOL, "m")
    lr, eps, b1 = OPT.lr, OPT.eps, OPT.b1
    near0, total = 0, 0
    for name, p in zip(names, got["params"]):
        w, m = want["params"][name], want["m"][name]
        diff, small = np.abs(p - w), np.abs(m) <= (1 - b1) * 1e3 * eps
        assert diff[~small].max(initial=0) <= 1e-3 * lr, name
        assert diff[small].max(initial=0) <= 2 * lr, name
        near0 += int((small & (diff > 1e-3 * lr)).sum())
        total += p.size
    assert near0 <= 1e-3 * total


@pytest.mark.parametrize("arch", ("llama4-scout-17b-a16e", "deepseek-v2-lite-16b"))
def test_fsdp_cuts_the_experts_as_the_reference_gathers_them(arch):
    """The FSDP specs of an MoE layer are the in_specs of the reference's
    explicit expert gather (``src/repro/models/moe.py:147-158``): the
    expert stacks ``P("model", fsdp, None)``, the shared experts over
    ``data`` on the dimension ``model`` leaves whole."""
    import types

    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    cfg = configs.smoke(arch)
    rules = with_fsdp(make_rules(cfg, mesh))
    specs = lm.param_specs(cfg, rules)
    layer = specs["groups"][0]["pos0"]["moe"]
    for name in ("wi_gate", "wi_up", "wo"):
        assert tuple(layer[name]) == ("model", "data", None), (name, layer[name])
    assert tuple(layer["router"]) == ("data", None)
    shared = layer["shared"]
    assert tuple(shared["wi_gate"]) == tuple(shared["wi_up"]) == ("data", "model")
    assert tuple(shared["wo"]) == ("model", "data")


def test_fsdp_checkpoint_restores_on_one_rank_and_on_2x1(runs):
    saved = runs["grids"][(2, 2)][0]["ckpt"]
    at_2x1 = runs["grids"][(2, 1)][0]["ckpt"]
    cfg = configs.smoke(CKPT_ARCH)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    like = {"params": params, "opt": init_opt_state(params)}
    one = tp._numpy(tree_leaves(ckpt_lib.restore(runs["ckpt"], 2, like, device="cpu")))
    assert os.path.isdir(os.path.join(runs["ckpt"], "step_00000002"))
    assert len(saved) == len(one) == len(at_2x1)
    for a, b, c in zip(saved, one, at_2x1):
        assert a.shape == b.shape == c.shape
        assert np.array_equal(a, b) and np.array_equal(a, c)

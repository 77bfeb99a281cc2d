"""Sharded training in ``repro_torch`` on the CPU: tensor, expert and data
parallelism with ZeRO-1 (``dist/sharding.py``, the layers' regions,
``moe_ffn``'s sharded branches, ``train.optimizer``, ``train.trainer``)
on spawned gloo ranks, held against the port's one-rank run and against
the JAX package.

Grids ``(data, model)`` = (1, 2), (2, 1) and (2, 2), one spawn of D × M
ranks per grid running every case (``run_grid``: one process per rank,
one torch thread each, ``file://`` init under the test's temporary
directory, a join timeout so that a hung rank fails the test). The ranks
start from a ``forkserver`` that imported torch and this module once;
this module imports no JAX at its top, so the ranks never do. The smoke
configs of granite-3-2b (dense, tied embeddings, KV heads replicated),
llama4-scout-17b-a16e (MoE, one shared expert), deepseek-v2-lite-16b
(MLA, MoE with shared experts, a dense prologue), mamba2-370m (the SSM's
heads over ``model``, ``w_zx`` cut part by part), zamba2-2.7b (the hybrid:
SSM layers and the shared attention block) and whisper-base (the encoder,
self- and cross-attention; frames from a seeded generator) run in float32
on the reference's weights, B=8 × 64 tokens.

What is held, with the tolerances:

* the loss, and every leaf's gradient gathered from the ranks, against
  the port's one-rank run: the loss within rtol 1e-5, each gradient within
  1e-5 of its one-rank norm in the 2-norm of the difference (float32
  rounding of sums split over ranks: the row-parallel products and the
  vocab-parallel softmax);
* one ``make_train_step`` (AdamW, ZeRO-1 over ``data`` where it is > 1)
  from the same state, gathered: ``m`` and ``v`` within 1e-5 of each
  leaf's one-rank norm (the gradients' rounding above, carried through one
  step); the parameters the step returns within 1e-5 too. AdamW's first
  step is about lr · g / (|g| + eps), which turns a gradient at rounding
  level whose sign the split sums flip into a change of up to 2·lr
  (measured on mamba2's embedding: one element with |g| ~1e-9 moves the
  leaf by 1.6e-5 of its norm). So on the configs of ``ROUNDING_LEVEL_ARCHS``
  an element whose one-rank |g| is at most ``ROUNDING_G`` of its leaf's
  largest |g| is held within 2·lr on its own and left out of the norm; on
  the others every element is in the norm. Besides, ``adamw_update`` from
  the same state on the one-rank gradients (each rank its shards of them)
  gives parameters within 1e-5 of the one-rank step's, every element held;
* the loss against the JAX package within rtol 1e-5 (``tests/
  test_torch_train.py``'s float32 tolerance): at (1, 2) and (2, 1)
  against the reference jitted in this process, which those grids do not
  change (measured 6.249453 at every grid on granite); at (2, 2) against
  the reference's own run on a ``(2, 2)`` mesh of 4 fake XLA devices in a
  subprocess (the recipe of ``tests/test_elastic.py``), where a MoE model
  routes each batch shard alone and its loss departs from the unsharded
  one (measured 6.793992 against 6.780680 on llama4). The port's one-rank
  run of that form (``local_capacity``: each half of the batch routed
  alone, the router statistics averaged before their product) stands in
  for the one-rank run at (2, 2) on the MoE configs.
"""

import functools
import math
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import textwrap
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (
    P,
    average_over_batch_,
    gather_shard,
    gather_tree,
    local_shard,
    make_rules,
    shard_tree,
)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.models import moe as t_moe
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    opt_state_specs,
)
from repro_torch.train.trainer import loss_and_grads, make_train_step
from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves, tree_unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-2b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b", "mamba2-370m",
         "zamba2-2.7b", "whisper-base")
GRIDS = ((1, 2), (2, 1), (2, 2))
B, S = 8, 64
LOSS_RTOL, GRAD_NORM_TOL, STEP_NORM_TOL = 1e-5, 1e-5, 1e-5
OPT = OptimizerConfig(lr=1e-3, warmup_steps=0)
#: Configs whose step parameters may hold gradients at rounding level, and
#: that level as a share of the leaf's largest one-rank |g| (10 float32 eps).
ROUNDING_LEVEL_ARCHS = ("mamba2-370m", "zamba2-2.7b", "whisper-base")
ROUNDING_G = 10 * float(np.finfo(np.float32).eps)
#: Seconds a grid's ranks may take before the test fails.
JOIN_TIMEOUT = 300


def grid_id(grid) -> str:
    return "x".join(map(str, grid))


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, init: str, grid, jobs, out: str, pg_timeout=None):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=pg_timeout)
        try:
            mesh = make_local_mesh(*grid, device_type="cpu")
            results = {name: fn(mesh, **kw) for name, fn, kw in jobs}
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_grid(grid, jobs, out, timeout: float = JOIN_TIMEOUT, pg_timeout=None) -> list[dict]:
    """Run ``jobs`` (``(name, fn, kwargs)``, ``fn(mesh, **kwargs)`` a
    function of this module) on D*M spawned gloo ranks of a
    ``make_local_mesh(*grid)`` mesh; returns each rank's ``{name:
    result}``. A rank that fails or outlives ``timeout`` fails the call,
    and every rank still running is stopped. ``pg_timeout`` (a
    ``timedelta``) bounds each collective of the ranks' process group."""
    world = math.prod(grid)
    os.makedirs(out, exist_ok=True)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed", __name__])
    init = "file://" + os.path.join(str(out), "init")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, grid, jobs, str(out), pg_timeout))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    errors = [open(os.path.join(str(out), f"rank{r}.err")).read()
              for r in range(world) if os.path.exists(os.path.join(str(out), f"rank{r}.err"))]
    assert not hung, f"grid {grid}: ranks {hung} still running after {timeout} s"
    assert not errors and all(proc.exitcode == 0 for proc in procs), \
        f"grid {grid}: exit codes {[proc.exitcode for proc in procs]}\n" + "\n".join(errors)
    results = []
    for r in range(world):
        with open(os.path.join(str(out), f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def full_params(cfg, leaves: dict):
    """The port's full parameter tree from its named numpy leaves (copies:
    a training step updates them in place)."""
    specs = lm.param_specs(cfg)
    return tree_unflatten(specs, [torch.tensor(leaves[name])
                                  for name, _ in tree_flatten_with_names(specs)])


def _numpy(tensors) -> list:
    return [t.detach().numpy().copy() for t in tensors]


def torch_batch(batch: dict) -> dict:
    """A numpy batch as tensors: the tokens as int64, the frames as they are."""
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def job_step(mesh, arch: str, leaves: dict, batch: dict, given: list):
    """On this rank: the loss and its gradients (gathered), then one
    ``make_train_step`` from fresh shards (``m`` and ``v`` gathered), and
    ``adamw_update`` from fresh shards on this rank's shards of the
    one-rank gradients ``given`` (the parameters gathered). Rank 0 returns
    all of it, every rank its loss."""
    cfg = configs.smoke(arch)
    rules = make_rules(cfg, mesh)
    specs = lm.param_specs(cfg)
    rows = P(tuple(rules.batch_axes))
    batch = {k: local_shard(v, rows, rules) for k, v in torch_batch(batch).items()}
    fn = lambda p, b: lm.train_loss(p, b, cfg, rules)  # noqa: E731
    params = shard_tree(full_params(cfg, leaves), specs, rules)
    loss, grads = loss_and_grads(fn, params, batch, cast_bf16=False)
    average_over_batch_(grads, rules)
    out = {"loss": float(loss), "rules": (rules.batch_axes, rules.model_axis),
           "grads": _numpy(gather_tree(tree_unflatten(params, grads), specs, rules))}
    params = shard_tree(full_params(cfg, leaves), specs, rules)
    opt_state = init_opt_state(params, specs, rules)
    step = make_train_step(fn, OPT, cast_bf16=False, param_specs=specs, rules=rules)
    params, opt_state, metrics = step(params, opt_state, batch)
    moment_specs = opt_state_specs(params, specs, mesh)["m"]
    out["moment_shapes"] = [(tuple(m.shape), tuple(p.shape)) for m, p in
                            zip(tree_leaves(opt_state["m"]), tree_leaves(params))]
    out["step_loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["params"] = _numpy(gather_tree(params, specs, rules))
    for k in ("m", "v"):
        out[k] = _numpy(gather_tree(opt_state[k], moment_specs, rules))
    params = shard_tree(full_params(cfg, leaves), specs, rules)
    grads = shard_tree(tree_unflatten(params, [torch.from_numpy(g) for g in given]), specs, rules)
    with torch.no_grad():
        adamw_update(OPT, params, grads, init_opt_state(params, specs, rules), specs=specs,
                     rules=rules)
    out["params_given"] = _numpy(gather_tree(params, specs, rules))
    return out if dist.get_rank() == 0 else {"loss": out["loss"]}


def job_regions(mesh):
    """The collectives of ``dist.sharding`` on this rank, with their
    gradients: ``reduce_from_model``, ``copy_to_model``,
    ``mean_over_batch``, ``gather_batch``, and ``local_shard`` /
    ``gather_shard`` over a dimension split by ("data", "model")."""
    rules = make_rules(configs.smoke("granite-3-2b"), mesh)
    c = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    me = torch.tensor([float(10 * c["data"] + c["model"] + 1)] * 3, requires_grad=True)
    out = {"coord": (c["data"], c["model"])}
    y = sharding.reduce_from_model(me * 2.0, rules)
    (y * 3.0).sum().backward()
    out["reduce_from"] = (y.detach().numpy().copy(), me.grad.numpy().copy())
    w = torch.ones(3, requires_grad=True)
    (sharding.copy_to_model(w, rules) * me.detach()).sum().backward()
    out["copy_to"] = w.grad.numpy().copy()
    me.grad = None
    z = sharding.mean_over_batch(me, rules)
    (z * 5.0).sum().backward()
    out["mean_over_batch"] = (z.detach().numpy().copy(), me.grad.numpy().copy())
    rows = torch.arange(4.0).reshape(2, 2) + 100 * c["data"]
    rows.requires_grad_(True)
    g = sharding.gather_batch(rows, rules)
    (g * torch.arange(1.0, g.numel() + 1).reshape(g.shape)).sum().backward()
    out["gather_batch"] = (g.detach().numpy().copy(), rows.grad.numpy().copy())
    full = torch.arange(48.0).reshape(8, 6)
    spec = P(("data", "model"), None)
    part = local_shard(full, spec, rules)
    out["local_shard"] = part.numpy().copy()
    out["gather_shard"] = gather_shard(part, spec, rules).numpy().copy()
    return out


def job_split_leaf(mesh):
    """``local_shard`` and ``gather_shard`` of a (2, 12) leaf split by 2
    parts over ``model`` (Mamba2's ``w_zx``: z | x)."""
    rules = make_rules(configs.smoke("mamba2-370m"), mesh)
    full = torch.arange(24.0).reshape(2, 12)
    part = local_shard(full, P(None, "model"), rules, parts=2)
    return part.numpy().copy(), gather_shard(part, P(None, "model"), rules, parts=2).numpy().copy()


def _dp_batch(cfg, b=4, s=16):
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1))).long()}
    if cfg.enc_dec:
        batch["enc"] = torch.from_numpy(
            rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32))
    return batch


def dp_run(arch: str, rules=None):
    """The loss and gradients of ``arch``'s smoke config (the port's own
    float32 weights, seed 0) on ``_dp_batch``: this rank's rows, the
    gradients averaged over the batch ranks, under ``rules``."""
    cfg = configs.smoke(arch)
    rules = rules or sharding.NO_SHARDING
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", rules=rules)
    rows = P(tuple(rules.batch_axes))
    batch = {k: local_shard(v, rows, rules) for k, v in _dp_batch(cfg).items()}
    loss, grads = loss_and_grads(lambda p, b: lm.train_loss(p, b, cfg, rules), params, batch,
                                 cast_bf16=False)
    average_over_batch_(grads, rules)
    return float(loss), _numpy(grads)


def job_dp(mesh, arch: str):
    """Data parallelism over every rank (no model axis)."""
    return dp_run(arch, make_rules(configs.smoke(arch), mesh))


def _state(cfg, rules, specs):
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", rules=rules)
    return {"params": params, "opt": init_opt_state(params, specs, rules)}


def _gathered(state, specs, rules) -> list:
    return _numpy(gather_tree(state, specs, rules))


def job_save(mesh, arch: str, ckpt_dir: str):
    """Two training steps on this mesh, then a checkpoint of step 2; the
    state gathered (rank 0)."""
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.trainer import state_specs

    cfg = configs.smoke(arch)
    rules, pspecs = make_rules(cfg, mesh), lm.param_specs(cfg)
    state = _state(cfg, rules, pspecs)
    step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg, rules), OPT, param_specs=pspecs,
                           rules=rules)
    rows = P(tuple(rules.batch_axes))
    for _ in range(2):
        batch = {k: local_shard(v, rows, rules) for k, v in _dp_batch(cfg).items()}
        step(state["params"], state["opt"], batch)
    specs = state_specs(state["params"], pspecs, rules)
    ckpt_lib.save(ckpt_dir, 2, state, specs=specs, rules=rules, block=True)
    full = _gathered(state, specs, rules)  # a collective: every rank gathers
    return full if dist.get_rank() == 0 else None


def job_restore(mesh, arch: str, ckpt_dir: str):
    """The checkpoint of step 2 restored on this mesh (this rank's shards,
    ZeRO-1 slices among them), gathered (rank 0)."""
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.trainer import state_specs

    cfg = configs.smoke(arch)
    rules, pspecs = make_rules(cfg, mesh), lm.param_specs(cfg)
    like = _state(cfg, rules, pspecs)
    specs = state_specs(like["params"], pspecs, rules)
    got = ckpt_lib.restore(ckpt_dir, 2, like, device="cpu", specs=specs, rules=rules)
    shapes = [(tuple(a.shape), tuple(b.shape)) for a, b in zip(tree_leaves(got), tree_leaves(like))]
    assert all(a == b for a, b in shapes), shapes
    full = _gathered(got, specs, rules)
    return full if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# the one-rank runs and the references (in this process)
# ---------------------------------------------------------------------------


@functools.cache
def reference_model(arch: str):
    """(the port's named numpy leaves of the reference's float32 weights,
    the batch: tokens (B, S+1), and an encoder-decoder model's frames)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.models import lm as j_lm
    from repro_torch.models.convert import params_from_numpy

    jcfg = j_configs.smoke(arch)
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), configs.smoke(arch), device="cpu")
    leaves = {name: t.numpy() for name, t in tree_flatten_with_names(tp)}
    return leaves, batch_of(jcfg)


def batch_of(cfg) -> dict:
    """The seeded numpy batch of a config: B × (S+1) tokens, and (B,
    enc_len, d_model) frames for an encoder-decoder model."""
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
             .astype(np.int32)}
    if cfg.enc_dec:
        batch["enc"] = (np.random.default_rng(1).standard_normal((B, cfg.enc_len, cfg.d_model))
                        .astype(np.float32))
    return batch


@functools.cache
def reference_loss(arch: str) -> float:
    """The JAX package's unsharded loss, jitted in this process."""
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.models import lm as j_lm

    jcfg = j_configs.smoke(arch)
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in reference_model(arch)[1].items()}
    return float(jax.jit(lambda p, b: j_lm.train_loss(p, b, jcfg))(jp, batch))


_SHARDED_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import json
import numpy as np
import jax
import jax.numpy as jnp
import repro
from repro import configs
from repro.dist.sharding import make_rules
from repro.launch.mesh import make_local_mesh
from repro.models import lm
out = {}
for arch in ARCHS:
    cfg = configs.smoke(arch)
    p = jax.jit(lambda k: lm.init_params(k, cfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
                                   .astype(np.int32))}
    if cfg.enc_dec:
        batch["enc"] = jnp.asarray(np.random.default_rng(1).standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32))
    mesh = make_local_mesh(2, 2)
    rules = make_rules(cfg, mesh)
    with jax.set_mesh(mesh):
        out[arch] = float(jax.jit(lambda p, b: lm.train_loss(p, b, cfg, rules))(p, batch))
print(json.dumps(out))
"""


@functools.cache
def reference_loss_2x2() -> dict:
    """The JAX package's loss on a (2, 2) mesh of 4 fake XLA devices, per
    arch (a subprocess: the device count is fixed before JAX starts)."""
    code = f"ARCHS, B, S = {ARCHS!r}, {B}, {S}\n" + textwrap.dedent(_SHARDED_REFERENCE)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    return json.loads(proc.stdout.strip().splitlines()[-1])


def local_capacity(shards: int):
    """``moe_ffn`` of a (shards, M) grid on one rank: each of ``shards``
    blocks of the batch routed alone (capacity from its own token count),
    the router statistics averaged over the blocks before their product."""

    def ffn(params, x, cfg, rules):
        outs, fracs, pbars = [], [], []
        for part in x.chunk(shards, 0):
            out, (frac, pbar) = t_moe._moe_local(params, part.reshape(-1, x.shape[-1]), cfg, 0,
                                                 cfg.n_experts, 1)
            outs.append(out.reshape(part.shape))
            fracs.append(frac)
            pbars.append(pbar)
        frac, pbar = sum(fracs) / shards, sum(pbars) / shards
        return torch.cat(outs), t_moe._aux_from_stats(frac, pbar, cfg.n_experts)

    return ffn


def one_rank(arch: str, local_shards: int = 1) -> dict:
    """The port's one-rank loss, gradients and ``make_train_step``, with
    MoE routed as ``local_capacity(local_shards)`` when that is > 1."""
    cfg = configs.smoke(arch)
    leaves, batch = reference_model(arch)
    batch = torch_batch(batch)
    fn = lambda p, b: lm.train_loss(p, b, cfg)  # noqa: E731
    saved = t_moe.moe_ffn
    if local_shards > 1:
        t_moe.moe_ffn = local_capacity(local_shards)
    try:
        params = full_params(cfg, leaves)
        loss, grads = loss_and_grads(fn, params, batch, cast_bf16=False)
        params = full_params(cfg, leaves)
        step = make_train_step(fn, OPT, cast_bf16=False)
        params, opt_state, metrics = step(params, init_opt_state(params), batch)
    finally:
        t_moe.moe_ffn = saved
    return {"loss": float(loss), "grads": _numpy(grads), "step_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "params": _numpy(tree_leaves(params)),
            "m": _numpy(tree_leaves(opt_state["m"])), "v": _numpy(tree_leaves(opt_state["v"]))}


@functools.cache
def one_rank_cached(arch: str, local_shards: int) -> dict:
    return one_rank(arch, local_shards)


def baseline(arch: str, grid) -> dict:
    """The one-rank run a grid is held to: the local-capacity form on a MoE
    config at (D > 1, M > 1), the plain one-rank run otherwise."""
    d, m = grid
    moe = configs.smoke(arch).is_moe
    return one_rank_cached(arch, d if (moe and d > 1 and m > 1) else 1)


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Every grid's rank results: {grid: [rank dicts]}."""
    out = {}
    for grid in GRIDS:
        jobs = [(arch, job_step, {"arch": arch, "leaves": reference_model(arch)[0],
                                  "batch": reference_model(arch)[1],
                                  "given": baseline(arch, grid)["grads"]}) for arch in ARCHS]
        out[grid] = run_grid(grid, jobs, tmp_path_factory.mktemp(f"tp{grid_id(grid)}"))
    return out


def _hold_norm(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.astype(np.float64)
        diff = float(np.linalg.norm(g.astype(np.float64) - w))
        assert diff <= tol * float(np.linalg.norm(w)) + 1e-30, (what, i, diff,
                                                                float(np.linalg.norm(w)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_loss_and_gathered_grads_equal_one_rank(grids, grid, arch):
    ranks = grids[grid]
    losses = [r[arch]["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses  # every rank holds the global loss
    got, want = ranks[0][arch], baseline(arch, grid)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert len(got["grads"]) == len(want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        assert g.shape == w.shape
    _hold_norm(got["grads"], want["grads"], GRAD_NORM_TOL, "grad")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_train_step_with_zero1_equals_one_rank(grids, grid, arch):
    got, want = grids[grid][0][arch], baseline(arch, grid)
    np.testing.assert_allclose(got["step_loss"], want["step_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GRAD_NORM_TOL)
    # ZeRO-1: over data > 1 the moments hold slices of the shards
    sliced = [m != p for m, p in got["moment_shapes"]]
    assert any(sliced) == (grid[0] > 1), (grid, got["moment_shapes"])
    for k in ("m", "v"):
        _hold_norm(got[k], want[k], STEP_NORM_TOL, k)
    _hold_norm(got["params_given"], want["params"], STEP_NORM_TOL, "params_given")
    if arch not in ROUNDING_LEVEL_ARCHS:
        _hold_norm(got["params"], want["params"], STEP_NORM_TOL, "params")
        return
    for i, (p, w, g) in enumerate(zip(got["params"], want["params"], want["grads"])):
        diff = np.abs(p.astype(np.float64) - w.astype(np.float64))
        level = np.abs(g) <= ROUNDING_G * float(np.abs(g).max())
        assert float(diff[level].max(initial=0.0)) <= 2 * OPT.lr, ("params", i)
        norm = float(np.linalg.norm(np.where(level, 0.0, diff)))
        assert norm <= STEP_NORM_TOL * float(np.linalg.norm(w.astype(np.float64))) + 1e-30, \
            ("params", i, norm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_loss_matches_the_reference(grids, grid, arch):
    got = grids[grid][0][arch]["loss"]
    want = reference_loss_2x2()[arch] if grid == (2, 2) else reference_loss(arch)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_moe_at_2x2_routes_each_batch_shard_alone(grids):
    """The reference's (2, 2) loss departs from its unsharded one on the MoE
    configs (capacity from the local token count), and the port follows
    it, not the unsharded value; granite does not depart."""
    for arch in ARCHS:
        moe = configs.smoke(arch).is_moe
        sharded, unsharded = reference_loss_2x2()[arch], reference_loss(arch)
        assert (abs(sharded - unsharded) > 10 * LOSS_RTOL * abs(unsharded)) == moe, arch
        got = grids[(2, 2)][0][arch]["loss"]
        assert abs(got - sharded) < abs(got - unsharded) or not moe, arch


def test_rules_of_each_grid(grids):
    for grid, ranks in grids.items():
        d, m = grid
        for arch in ARCHS:
            batch_axes, model_axis = ranks[0][arch]["rules"]
            assert batch_axes == (("data",) if d > 1 else ())
            assert model_axis == ("model" if m > 1 else None)

"""Context parallelism in ``repro_torch`` on the CPU: the reference's
``REPRO_OPT=cp_seq`` rules (``context_parallel=True, shard_heads=False``),
under which each model rank runs its block of S/M positions with every
head (``dist.sharding.seq_block``), its layers' weights gathered over
``model`` where they run, K and V (MLA: the latent) gathered along the
sequence, MoE's tokens gathered and its outputs reduce-scattered, on
spawned gloo ranks held against the port's one-rank run, the port's
tensor-parallel prefill and the JAX package's own run under the same
rules.

Grids ``(data, model)`` = (1, 2) and (2, 2), the latter under FSDP as the
train cell runs (``with_fsdp``), with the smoke configs of granite-3-2b
(dense GQA, tied embeddings), gemma3-12b (sliding window: a window of 8
against blocks of 16 positions), deepseek-v2-lite-16b (MLA, MoE with
shared experts, a dense prologue), llama4-scout-17b-a16e (MoE with a
shared expert) and whisper-base (the encoder cut over the model ranks,
cross-attention), in float32 on the port's seeded weights (carried to
the JAX package leaf for leaf), B=4 × 32 tokens; and granite at (1, 3)
with S = 48, whose 4 heads, MLP columns and vocabulary the three model
ranks hold in uneven ``Blocks`` and gather so. One spawn per grid
(``test_torch_tp.run_grid``).

What is held, with ``tests/test_torch_tp.py``'s tolerances:

* the loss (every rank's equal) within rtol 1e-5 of the one-rank run's
  (``test_torch_tp.baseline``'s rule: at (2, 2) a MoE config routes each
  batch shard alone, as the reference's ``shard_map`` does), and every
  leaf's averaged gradient gathered from the ranks within 1e-5 of its
  one-rank norm, or within ``FLOOR_FACTOR`` times the leaf's rounding
  floor where that is larger: the one-rank float32 gradient's own
  distance from the same run in float64, of its norm (``one_rank``). Only
  the MoE routers' floors exceed 1e-5 here (llama4's 1.1e-5: their
  gradients are sums over every token with heavy cancellation, and the
  split over model ranks sums them in another order);
* one ``make_train_step``: ``m`` and ``v`` gathered within the same bound
  (``v``, a square, within twice it), the parameters as
  ``test_torch_tp.py`` holds those of its ``ROUNDING_LEVEL_ARCHS``, on
  every config: AdamW's first step moves an element whose gradient is at
  rounding level by up to 2·lr whichever sign the split sums give it
  (llama4's attention on these weights), so such an element is held
  within 2·lr on its own and the others within 1e-5 of the leaf's norm;
* the forward's logits gathered along the sequence (and the rows) within
  1e-5 of the one-rank logits' norm;
* the prefill: its last logits (the whole vocabulary, alike on every rank)
  and every rank's split-KV caches within 1e-5 of the norm of the
  tensor-parallel prefill's on the same mesh (the same cache layout), and
  ``NEW`` greedy decode steps under the tensor-parallel rules from each:
  the same tokens, the logits within 1e-5 of the norm;
* the loss and the forward's logits against the JAX package's run under
  ``context_parallel=True, shard_heads=False`` on a (2, 2) mesh of 4 fake
  XLA devices (a subprocess, started first and run beside the ranks, on
  the port's weights stacked into the reference's tree): the loss within
  rtol 1e-5, the logits within 1e-5 of their norm;
* a ``CollectiveLedger`` around granite's training step at (1, 2) counts,
  on each rank and by op, what the dry run of the same cell counts
  (``launch.specs.make_cell`` under ``REPRO_OPT=cp_seq``);
* the dry run's ``peak_tensors`` (the temporaries at the peak, grouped)
  sum to the record's temporaries, and its card path counts softmax's
  backward workspace (``dryrun.workspace_bytes``), which the plain path
  does not.
"""

import functools
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
    gather_over_model,
    gather_shard,
    gather_tree,
    local_shard,
    make_rules,
    shard_tree,
    with_context_parallel,
    with_fsdp,
)
from repro_torch.models import lm
from repro_torch.models import moe as t_moe
from repro_torch.train.optimizer import init_opt_state, opt_state_specs
from repro_torch.train import trainer
from repro_torch.train.trainer import loss_and_grads, make_train_step
from repro_torch.utils.collectives import CollectiveLedger
from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves, tree_map, tree_unflatten

ARCHS = ("granite-3-2b", "gemma3-12b", "deepseek-v2-lite-16b", "llama4-scout-17b-a16e",
         "whisper-base")
GRIDS = ((1, 2), (2, 2))
B, S = 4, 32
#: The model ranks that split granite's 4 smoke heads, its MLP columns and
#: its vocabulary unevenly, and a sequence they divide.
UNEVEN_GRID, UNEVEN_S = (1, 3), 48
#: Greedy decode steps after each prefill.
NEW = 4
TOL = 1e-5
#: A leaf's allowed departure in units of its one-rank float32 rounding
#: floor (chip_smoke.py's ``REORDER_FACTOR``).
FLOOR_FACTOR = 2
OPT = tp.OPT
LEDGER_ARCH, LEDGER_GRID = "granite-3-2b", (1, 2)


def cases():
    """``(grid, arch, S)`` of every rank job."""
    return ([(g, a, S) for g in GRIDS for a in ARCHS]
            + [(UNEVEN_GRID, "granite-3-2b", UNEVEN_S)])


def case_id(grid, arch, s) -> str:
    return f"{tp.grid_id(grid)}-{arch}" + (f"-s{s}" if s != S else "")


def cp_rules(cfg, mesh, fsdp: bool = False):
    """The reference's ``cp_seq`` rules on ``mesh`` (``with_context_parallel``),
    with the train cell's FSDP when ``fsdp``."""
    rules = with_context_parallel(make_rules(cfg, mesh))
    return with_fsdp(rules) if fsdp else rules


@functools.cache
def weights(arch: str) -> dict:
    """The port's float32 weights of ``arch``'s smoke config (seed 0), by
    leaf name, as numpy arrays."""
    cfg = configs.smoke(arch)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    return {name: t.numpy() for name, t in tree_flatten_with_names(params)}


def batch_of(arch: str, s: int) -> dict:
    """The seeded numpy batch: B × (s + 1) tokens, and an encoder-decoder
    model's (B, enc_len, d_model) frames."""
    cfg = configs.smoke(arch)
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (B, s + 1))
             .astype(np.int32)}
    if cfg.enc_dec:
        batch["enc"] = (np.random.default_rng(1).standard_normal((B, cfg.enc_len, cfg.d_model))
                        .astype(np.float32))
    return batch


def step_with_grads(fn, params, batch, **kw):
    """One ``make_train_step`` of ``fn`` on ``params`` (updated in place),
    and the gradients the step averaged: ``(metrics, opt_state, grads)``."""
    seen = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[1])
        return out

    real = trainer.loss_and_grads
    trainer.loss_and_grads = spy
    try:
        specs, rules = kw.get("param_specs"), kw.get("rules")
        opt_state = (init_opt_state(params, specs, rules) if rules is not None
                     else init_opt_state(params))
        _, opt_state, metrics = make_train_step(fn, OPT, cast_bf16=False, **kw)(
            params, opt_state, batch)
    finally:
        trainer.loss_and_grads = real
    return metrics, opt_state, seen[0]


# ---------------------------------------------------------------------------
# rank jobs
# ---------------------------------------------------------------------------


def job_cp(mesh, arch: str, leaves: dict, batch: dict, s: int, fsdp: bool):
    """On this rank, under the ``cp_seq`` rules: one ``make_train_step``
    under a ledger (its count by op), the loss, the gradients it averaged
    and the state after it, gathered; the forward's logits gathered along
    the sequence and the rows; then the prefill beside the tensor-parallel
    one on this mesh and ``NEW`` greedy decode steps from each. Rank 0
    returns all of it, the others what they hold alone (loss, ledger,
    caches, tokens)."""
    cfg = configs.smoke(arch)
    rules = cp_rules(cfg, mesh, fsdp)
    specs = lm.param_specs(cfg, rules)
    rows = P(tuple(rules.batch_axes))
    batch = {k: local_shard(v, rows, rules) for k, v in tp.torch_batch(batch).items()}
    fn = lambda p, b: lm.train_loss(p, b, cfg, rules)  # noqa: E731
    params = shard_tree(tp.full_params(cfg, leaves), specs, rules)
    with CollectiveLedger() as led:
        metrics, opt_state, grads = step_with_grads(fn, params, batch, param_specs=specs,
                                                    rules=rules)
    moment_specs = opt_state_specs(params, specs, mesh)["m"]
    out = {"loss": float(metrics["loss"]), "context_parallel": rules.context_parallel,
           "ledger": tp_ops(led.records), "grad_norm": float(metrics["grad_norm"]),
           "grads": tp._numpy(gather_tree(tree_unflatten(params, grads), specs, rules)),
           "params": tp._numpy(gather_tree(params, specs, rules))}
    for k in ("m", "v"):
        out[k] = tp._numpy(gather_tree(opt_state[k], moment_specs, rules))

    serve, tp_rules = cp_rules(cfg, mesh), make_rules(cfg, mesh)
    params = shard_tree(tp.full_params(cfg, leaves), lm.param_specs(cfg), serve)
    toks, enc = batch["tokens"][:, :-1], batch.get("enc")
    with torch.no_grad():
        logits, _ = lm.forward(params, toks, cfg, serve, enc_in=enc)
        out["logits"] = gather_shard(gather_over_model(logits, 1, serve), rows, serve).numpy()
        served = {}
        for key, r in (("cp", serve), ("tp", tp_rules)):
            last, caches = lm.prefill(params, toks, cfg, r, max_seq=s + NEW, enc_in=enc)
            if key == "tp":  # the tensor-parallel logits are the rank's vocabulary columns
                last = gather_over_model(last, 1, r, cfg.vocab_padded)
            steps, fed = [last], []
            for i in range(NEW):
                tok = torch.argmax(steps[-1][:, :cfg.vocab], -1)
                fed.append(tok)
                pos = torch.full((toks.shape[0],), s + i, dtype=torch.int64)
                step_logits, caches = lm.decode_step(params, tok, caches, pos, cfg, tp_rules)
                steps.append(gather_over_model(step_logits, 1, tp_rules, cfg.vocab_padded))
            served[key] = {"logits": [t[:, :cfg.vocab].numpy() for t in steps],
                           "tokens": torch.stack(fed, 1).numpy(),
                           "caches": [t.numpy() for t in tree_leaves(caches)]}
    out["served"] = served
    keep = ("loss", "served", "context_parallel", "ledger")
    return out if dist.get_rank() == 0 else {k: out[k] for k in keep}


def tp_ops(records) -> dict:
    """A ledger's count of each op."""
    out: dict = {}
    for r in records:
        out[r["op"]] = out.get(r["op"], 0) + 1
    return out


# ---------------------------------------------------------------------------
# the one-rank runs and the reference (in this process, and a subprocess)
# ---------------------------------------------------------------------------


@functools.cache
def one_rank(arch: str, s: int, local_shards: int) -> dict:
    """The port's one-rank ``make_train_step`` (the loss, the gradients and
    the state after it) and forward logits on ``batch_of(arch, s)``, MoE
    routed as ``test_torch_tp.local_capacity(local_shards)`` when that is
    > 1."""
    cfg = configs.smoke(arch)
    batch = tp.torch_batch(batch_of(arch, s))
    saved = t_moe.moe_ffn
    if local_shards > 1:
        t_moe.moe_ffn = tp.local_capacity(local_shards)
    try:
        with torch.no_grad():
            logits = lm.forward(tp.full_params(cfg, weights(arch)), batch["tokens"][:, :-1], cfg,
                                enc_in=batch.get("enc"))[0].numpy()
        params = tp.full_params(cfg, weights(arch))
        metrics, opt_state, grads = step_with_grads(lambda p, b: lm.train_loss(p, b, cfg),
                                                    params, batch)
        wide = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        _, grads64 = loss_and_grads(lambda p, b: lm.train_loss(p, b, cfg),
                                    tree_map(torch.Tensor.double,
                                             tp.full_params(cfg, weights(arch))),
                                    wide, cast_bf16=False)
    finally:
        t_moe.moe_ffn = saved
    floors = [float((g.double() - w).norm() / max(float(w.norm()), 1e-300))
              for g, w in zip(grads, grads64)]
    return {"loss": float(metrics["loss"]), "grads": tp._numpy(grads), "floors": floors,
            "grad_norm": float(metrics["grad_norm"]), "params": tp._numpy(tree_leaves(params)),
            "m": tp._numpy(tree_leaves(opt_state["m"])),
            "v": tp._numpy(tree_leaves(opt_state["v"])), "logits": logits}


def baseline(arch: str, grid, s: int) -> dict:
    """The one-rank run a grid is held to (``test_torch_tp.baseline``'s
    rule)."""
    d, m = grid
    moe = configs.smoke(arch).is_moe
    return one_rank(arch, s, d if (moe and d > 1 and m > 1) else 1)


_REFERENCE_CP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
from dataclasses import replace
import numpy as np
import jax
import jax.numpy as jnp
import repro
from repro import configs
from repro.dist.sharding import make_rules
from repro.launch.mesh import make_local_mesh
from repro.models import lm


def stacked(cfg, leaves):
    # the port's leaves (groups/3/pos0/attn/wq) stacked into the reference's tree
    like = jax.eval_shape(lambda k: lm.init_params(k, cfg, dtype=jnp.float32),
                          jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    out = []
    for path, leaf in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] in ("groups", "enc_groups"):
            a = np.stack([leaves["/".join([keys[0], str(g)] + keys[1:])]
                          for g in range(leaf.shape[0])])
        else:
            a = leaves["/".join(keys)]
        assert a.shape == leaf.shape, (keys, a.shape, leaf.shape)
        out.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, out)


out = {}
mesh = make_local_mesh(2, 2)
for arch in ARCHS:
    cfg = configs.smoke(arch)
    with np.load(f"{WEIGHTS}/{arch}.npz") as data:
        p = stacked(cfg, {k: data[k] for k in data.files})
    batch = {"tokens": jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
                                   .astype(np.int32))}
    if cfg.enc_dec:
        batch["enc"] = jnp.asarray(np.random.default_rng(1).standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32))
    rules = replace(make_rules(cfg, mesh), context_parallel=True, shard_heads=False)
    with jax.set_mesh(mesh):
        out[arch + "|loss"] = np.float64(jax.jit(lambda p, b: lm.train_loss(p, b, cfg, rules))(
            p, batch))
        out[arch + "|logits"] = np.asarray(jax.jit(
            lambda p, t, e: lm.forward(p, t, cfg, rules, enc_in=e)[0])(
                p, batch["tokens"][:, :-1], batch.get("enc")))
np.savez(OUT, **out)
"""


def start_reference(tmp):
    """The JAX package's run under the ``cp_seq`` rules on a (2, 2) mesh, on
    the port's weights (written under ``tmp`` first), in a subprocess
    writing ``tmp/reference.npz``."""
    for arch in ARCHS:
        np.savez(tmp / f"{arch}.npz", **weights(arch))
    code = (f"ARCHS, B, S, WEIGHTS, OUT = {ARCHS!r}, {B}, {S}, {str(tmp)!r}, "
            f"{str(tmp / 'reference.npz')!r}\n" + textwrap.dedent(_REFERENCE_CP))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=tp.ROOT)


def reference_results(proc, path) -> dict:
    """``{arch: {"loss", "logits"}}`` of ``start_reference``'s run."""
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            arch, kind = key.split("|")
            out.setdefault(arch, {})[kind] = data[key]
    return out


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"grids": {grid: [rank dicts]}, "reference": {arch: {...}}}``."""
    tmp = tmp_path_factory.mktemp("cp")
    proc = start_reference(tmp)
    try:
        grids = {}
        for grid in GRIDS + (UNEVEN_GRID,):
            jobs = [(case_id(g, a, s), job_cp, {"arch": a, "leaves": weights(a),
                                                 "batch": batch_of(a, s), "s": s,
                                                 "fsdp": g[0] > 1})
                    for g, a, s in cases() if g == grid]
            grids[grid] = tp.run_grid(grid, jobs, tmp / f"grid{tp.grid_id(grid)}")
        reference = reference_results(proc, tmp / "reference.npz")
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"grids": grids, "reference": reference}


def _hold_norm(got, want, tol, what):
    """Each ``got`` within ``tol`` (one bound, or one per leaf) of its
    ``want``'s norm, in the 2-norm of the difference."""
    tols = tol if isinstance(tol, list) else [tol] * len(want)
    for i, (g, w, t) in enumerate(zip(got, want, tols)):
        w = np.asarray(w, dtype=np.float64)
        diff = float(np.linalg.norm(np.asarray(g, dtype=np.float64) - w))
        assert diff <= t * float(np.linalg.norm(w)) + 1e-30, (what, i, diff,
                                                              float(np.linalg.norm(w)), t)


def allowed(want) -> list:
    """Each leaf's bound: ``TOL``, or ``FLOOR_FACTOR`` times its rounding
    floor where that is larger."""
    return [max(TOL, FLOOR_FACTOR * f) for f in want["floors"]]


CASES = cases()
IDS = [case_id(*c) for c in CASES]


@pytest.mark.parametrize("grid,arch,s", CASES, ids=IDS)
def test_cp_loss_and_gathered_grads_equal_one_rank(runs, grid, arch, s):
    ranks = [r[case_id(grid, arch, s)] for r in runs["grids"][grid]]
    assert all(r["context_parallel"] for r in ranks)
    losses = [r["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses  # every rank holds the global loss
    got, want = ranks[0], baseline(arch, grid, s)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    assert [g.shape for g in got["grads"]] == [w.shape for w in want["grads"]]
    _hold_norm(got["grads"], want["grads"], allowed(want), "grad")


@pytest.mark.parametrize("grid,arch,s", CASES, ids=IDS)
def test_cp_train_step_equals_one_rank(runs, grid, arch, s):
    got, want = runs["grids"][grid][0][case_id(grid, arch, s)], baseline(arch, grid, s)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=TOL)
    _hold_norm(got["m"], want["m"], allowed(want), "m")
    _hold_norm(got["v"], want["v"], [2 * t for t in allowed(want)], "v")
    for i, (p, w, g) in enumerate(zip(got["params"], want["params"], want["grads"])):
        diff = np.abs(p.astype(np.float64) - w.astype(np.float64))
        level = np.abs(g) <= tp.ROUNDING_G * float(np.abs(g).max())
        assert float(diff[level].max(initial=0.0)) <= 2 * OPT.lr, ("params", i)
        norm = float(np.linalg.norm(np.where(level, 0.0, diff)))
        assert norm <= TOL * float(np.linalg.norm(w.astype(np.float64))) + 1e-30, \
            ("params", i, norm)


@pytest.mark.parametrize("grid,arch,s", CASES, ids=IDS)
def test_cp_logits_gathered_along_the_sequence_equal_one_rank(runs, grid, arch, s):
    got, want = runs["grids"][grid][0][case_id(grid, arch, s)], baseline(arch, grid, s)
    assert got["logits"].shape == want["logits"].shape
    _hold_norm([got["logits"]], [want["logits"]], TOL, "logits")


@pytest.mark.parametrize("grid,arch,s", CASES, ids=IDS)
def test_cp_prefill_equals_the_tensor_parallel_prefill(runs, grid, arch, s):
    """Every rank: the prefill's last logits and its split-KV caches within
    1e-5 of the tensor-parallel prefill's norm, and the greedy decode steps
    under the tensor-parallel rules from each alike."""
    for r in runs["grids"][grid]:
        cp, tpp = r[case_id(grid, arch, s)]["served"]["cp"], r[case_id(grid, arch, s)]["served"]["tp"]
        assert [c.shape for c in cp["caches"]] == [c.shape for c in tpp["caches"]]
        _hold_norm(cp["caches"], tpp["caches"], TOL, "caches")
        _hold_norm(cp["logits"], tpp["logits"], TOL, "logits")
        assert np.array_equal(cp["tokens"], tpp["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cp_matches_the_reference(runs, arch):
    got = runs["grids"][(2, 2)][0][case_id((2, 2), arch, S)]
    want = runs["reference"][arch]
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=TOL)
    _hold_norm([got["logits"]], [want["logits"]], TOL, "logits")


@pytest.mark.parametrize("rank", range(2))
def test_cp_ledger_counts_what_the_dry_run_counts(runs, monkeypatch, rank):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import fake_world

    got = runs["grids"][LEDGER_GRID][rank][case_id(LEDGER_GRID, LEDGER_ARCH, S)]["ledger"]
    monkeypatch.setenv("REPRO_OPT", "cp_seq")
    cfg = configs.smoke(LEDGER_ARCH)
    with fake_world(LEDGER_GRID, ("data", "model"), rank=rank) as mesh:
        cell = specs.make_cell(cfg, ShapeSpec("t", "train", S, B), mesh, opt_cfg=OPT,
                               accum_steps=1, device="cpu", fsdp=False)
        rec = dryrun.trace_cell(cell, mesh, rank=rank, verbose=False)
    assert rec["context_parallel"] and rec["head_block"] == [0, cfg.n_heads]
    assert {op: a["count"] for op, a in rec["collectives"]["by_op"].items()} == got
    assert got.get("reduce-scatter", 0) > 0 and got.get("all-gather", 0) > 0


def test_peak_tensors_group_the_temporaries_at_the_peak(monkeypatch):
    """A record's ``peak_tensors`` groups the storages alive at the peak:
    their bytes sum to the record's temporaries and, by op, to
    ``temp_by_op_at_peak``, and the context-parallel train cell's gathered
    weights (``cat`` of the model blocks) are among them."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import fake_world

    monkeypatch.setenv("REPRO_OPT", "cp_seq")
    cfg = configs.smoke("granite-3-2b")
    with fake_world((1, 2), ("data", "model"), rank=0) as mesh:
        cell = specs.make_cell(cfg, ShapeSpec("t", "train", S, B), mesh, opt_cfg=OPT,
                               accum_steps=1, device="cpu")
        rec = dryrun.trace_cell(cell, mesh, verbose=False)
    groups = rec["peak_tensors"]
    assert sum(g["bytes"] for g in groups) == rec["memory"]["temp_size_in_bytes"]
    assert [g["bytes"] for g in groups] == sorted((g["bytes"] for g in groups), reverse=True)
    by_op: dict = {}
    for g in groups:
        by_op[g["op"]] = by_op.get(g["op"], 0) + g["bytes"]
    assert by_op == rec["temp_by_op_at_peak"]
    assert any(g["op"] == "cat" and g["shape"] == [cfg.d_model, cfg.d_ff] for g in groups)


def test_card_path_counts_the_softmax_backward_workspace():
    """On the card's path the tracer counts the workspace of softmax's
    CUDA backward (``dryrun.workspace_bytes``: its ``grad * output``, and a
    contiguous copy of a strided gradient) while it runs; the plain path
    counts none."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun

    def peaks(strided: bool):
        out = {}
        for card in (False, True):
            mode = FakeTensorMode()
            with mode:
                x = torch.empty(8, 64, 256).requires_grad_(True)
                g = torch.empty(8, 256, 64).transpose(1, 2) if strided else torch.empty(8, 64, 256)
            with contextlib.ExitStack() as stack:
                stack.enter_context(mode)
                tracer = stack.enter_context(dryrun._Tracer(dryrun.storages((x, g)), card=card))
                torch.autograd.grad(torch.softmax(x, -1), x, g)
            out[card] = (tracer.peak, tracer.peak_by_op, tracer.peak_tensors())
        return out

    size = 8 * 64 * 256 * 4  # the softmax's output, and its gradient
    for strided, extra in ((False, size), (True, 2 * size)):
        got = peaks(strided)
        # the saved output and the backward's result, then the workspace
        assert got[False][0] == 2 * size and got[True][0] == 2 * size + extra, got
        assert got[True][1]["_softmax_backward_data workspace"] == extra
        assert "_softmax_backward_data workspace" not in got[False][1]
        # the grouped peak holds the workspace too, at the output's shape
        assert {"op": "_softmax_backward_data workspace", "shape": [8, 64, 256],
                "dtype": "float32", "count": 1, "bytes": extra} in got[True][2]

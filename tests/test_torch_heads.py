"""Attention heads that the model ranks do not split evenly, on the CPU.

The model ranks hold balanced blocks of the heads (``attention.head_block``:
``numpy.array_split``'s cut, the first ``H % M`` ranks one head more, a
block empty where H < M), and ``dist.sharding.Blocks`` cuts ``wq``'s
columns, ``wo``'s rows, the MLP's columns and the vocabulary at those
boundaries. A block may cut across GQA groups (``attention.kv_runs``).

What is held:

* the blocks cover [0, H), differ by at most one head and put a largest
  first, and equal the even cut wherever M divides H, for every config's
  heads at M in {1, 2, 4, 8, 16}; ``kv_runs`` on blocks that cut across
  groups; ``by_runs`` of the GQA attentions against each run's heads
  attended alone;
* on spawned gloo ranks (``test_torch_tp.run_grid``), smoke configs with
  head overrides in float32 on the JAX package's weights, B=4 x 16 tokens:
  granite with 6 q and 2 KV heads at (1, 4) and llama4's smoke (4
  experts) with 6 heads at (1, 4), whose blocks straddle groups of 3;
  whisper at (1, 3); granite with 8 and 2 at (1, 3), whose rank 1 reads
  its groups in two runs; granite with 2 q heads at (1, 3), whose rank 2
  holds none; and that config under FSDP at (2, 3). On each: the forward
  logits gathered (model ranks, then batch ranks), the loss and every
  gradient gathered, one ``make_train_step``'s loss and global gradient
  norm, ``adamw_update`` on this rank's shards of the one-rank gradients
  (the global norm over uneven and empty shards, the update, the
  parameters gathered), and (but under FSDP, a training layout) the greedy
  tokens of ``Engine.generate`` (a prefill and 4 decode steps), against
  the port's one-rank run: the loss and the norm within rtol 1e-5, logits,
  gradients and the update within 1e-5 of each one-rank leaf's norm
  (``test_torch_tp``'s float32 tolerances), tokens equal. The forward logits and the loss are
  also held against the JAX package's one-device run on the same
  converted weights, within ``test_torch_attention``'s float32 atol 1e-4
  on logits and rtol 1e-5 on the loss;
* ``local_shard`` / ``gather_shard`` of ``Blocks`` leaves with uneven and
  empty blocks, and ``gather_over_model(count=)``, round trip;
* a checkpoint saved at (1, 3) restores equal, bit for bit, on one rank
  and at (1, 4);
* the dry run on a fake (1, 16) world: smoke-width configs with 56/8,
  40/8 and 8/8 heads (yi-34b's, llama4-scout's, whisper-base's at 16
  model ranks) give ``ok`` decode records naming the traced rank's block,
  and their argument bytes summed over the 16 ranks equal the one-rank
  bytes plus 15 times the replicated ones, exactly.

This module imports no JAX at its top: the ranks import it.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist.sharding import (
    Blocks,
    P,
    ShardingRules,
    average_over_batch_,
    block_sizes,
    gather_over_model,
    gather_shard,
    gather_tree,
    local_shard,
    make_rules,
    model_index,
    shard_tree,
    split_block,
    with_fsdp,
)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import fake_world
from repro_torch.models import attention, lm
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.train.trainer import loss_and_grads, make_train_step
from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves, tree_unflatten
from test_torch_tp import (
    GRAD_NORM_TOL,
    LOSS_RTOL,
    OPT,
    STEP_NORM_TOL,
    _numpy,
    full_params,
    grid_id,
    run_grid,
    torch_batch,
)

B, S, NEW = 4, 16, 4
LOGIT_ATOL = 1e-4  # against the JAX package (tests/test_torch_attention.py)
NAMES = ("data", "model")
#: name -> (arch, overrides, (data, model) grid, FSDP)
CASES = {
    "granite-6h": ("granite-3-2b", dict(n_heads=6, n_kv_heads=2), (1, 4), False),
    "llama4-6h": ("llama4-scout-17b-a16e", dict(n_heads=6), (1, 4), False),
    "whisper": ("whisper-base", {}, (1, 3), False),
    "granite-8h": ("granite-3-2b", dict(n_heads=8, n_kv_heads=2), (1, 3), False),
    "granite-2h": ("granite-3-2b", dict(n_heads=2, n_kv_heads=1), (1, 3), False),
    "granite-2h-fsdp": ("granite-3-2b", dict(n_heads=2, n_kv_heads=1), (2, 3), True),
}
#: The case whose state is saved at (1, 3) and restored at (1, 4).
CKPT_CASE = "granite-8h"
GRIDS = ((1, 3), (1, 4), (2, 3))


def case_cfg(name: str):
    arch, overrides, _, _ = CASES[name]
    return configs.smoke(arch).with_overrides(dtype="float32", **overrides)


# ---------------------------------------------------------------------------
# blocks, runs and the GQA attentions over runs (no ranks)
# ---------------------------------------------------------------------------


class _Mesh:
    """A (1, size) mesh seen from model rank ``index`` (no process group:
    the block helpers read only its sizes and this rank's coordinate)."""

    mesh_dim_names = NAMES

    def __init__(self, size: int, index: int):
        self.shape, self.index = (1, size), index

    def get_coordinate(self):
        return [0, self.index]


def _rules(size: int, index: int) -> ShardingRules:
    return ShardingRules(mesh=_Mesh(size, index), model_axis="model" if size > 1 else None)


def _all_heads() -> list:
    return sorted({cfg.n_heads for arch in configs.ARCH_NAMES
                   for cfg in (configs.get(arch), configs.smoke(arch))})


@pytest.mark.parametrize("m", (1, 2, 4, 8, 16))
def test_head_blocks_are_balanced_and_even_where_m_divides(m):
    for h in _all_heads():
        blocks = [attention.head_block(h, _rules(m, r)) for r in range(m)]
        assert blocks[0][0] == 0 and blocks[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [hi - lo for lo, hi in blocks]
        assert max(sizes) - min(sizes) <= 1 and sizes[0] == max(sizes)
        assert sizes == block_sizes(h, m) == [len(p) for p in np.array_split(np.arange(h), m)]
        if h % m == 0:
            assert blocks == [(r * h // m, (r + 1) * h // m) for r in range(m)]


def test_kv_runs_cut_a_block_at_its_groups():
    yi = configs.get("yi-34b")  # 56 q heads in groups of 7 over 16 ranks
    assert attention.head_blocks(yi, _rules(16, 1)) == ((4, 8), (0, 2))
    assert attention.kv_runs(yi, _rules(16, 1)) == [(0, 3, 0, 1), (3, 4, 1, 2)]
    assert attention.kv_runs(yi, _rules(16, 3)) == [(0, 4, 0, 2)]  # 2 + 2: one run
    granite = configs.get("granite-3-2b")  # 32 in groups of 4 over 3: 11, 11, 10
    assert [attention.head_block(32, _rules(3, r)) for r in range(3)] == [(0, 11), (11, 22),
                                                                          (22, 32)]
    assert attention.kv_runs(granite, _rules(3, 1)) == [(0, 1, 0, 1), (1, 9, 1, 3), (9, 11, 3, 4)]
    whisper = configs.get("whisper-base")  # 8 over 16: ranks 8-15 hold none
    assert attention.head_blocks(whisper, _rules(16, 9)) == ((8, 8), (8, 8))
    assert attention.kv_runs(whisper, _rules(16, 9)) == []
    for cfg in (yi, granite, whisper):
        assert attention.kv_runs(cfg) == [(0, cfg.n_heads, 0, cfg.n_kv_heads)]


@pytest.mark.parametrize("fn", ("causal", "blocked", "banded", "decode"))
def test_by_runs_equals_each_run_attended_alone(fn):
    """A block of q heads 4-7 of groups 7 wide (yi-34b's rank 1 of 16) over
    the two KV heads it reads, against each head attended alone with its
    own KV head; an empty block gives an empty output."""
    g = torch.Generator().manual_seed(0)
    b, s, dh = 2, 8, 16
    s_q = 1 if fn == "decode" else s
    q = torch.randn((b, s_q, 4, dh), generator=g)
    k, v = torch.randn((b, s, 2, dh), generator=g), torch.randn((b, s, 2, dh), generator=g)
    pos = torch.arange(s)[None].expand(b, s)
    args = {"causal": (attention.causal_attention, (pos, pos)),
            "blocked": (attention.blocked_attention, (pos, pos, 0, 4)),
            "banded": (attention.banded_attention, (pos, 4)),
            "decode": (attention.decode_attention, (torch.tensor([5, 8]),))}[fn]
    runs = [(0, 3, 0, 1), (3, 4, 1, 2)]
    got = attention.by_runs(args[0], q, k, v, runs, *args[1])
    kv_of = [0, 0, 0, 1]
    for h in range(4):
        want = args[0](q[:, :, h:h + 1], k[:, :, kv_of[h]:kv_of[h] + 1],
                       v[:, :, kv_of[h]:kv_of[h] + 1], *args[1])
        torch.testing.assert_close(got[:, :, h:h + 1], want, rtol=1e-6, atol=1e-6)
    empty = attention.by_runs(args[0], q[:, :, :0], k[:, :, :0], v[:, :, :0], [], *args[1])
    assert empty.shape == (b, s_q, 0, dh)


# ---------------------------------------------------------------------------
# the gloo ranks' jobs
# ---------------------------------------------------------------------------


def run_case(mesh, name: str, leaves: dict, batch: dict, prompts, enc, given=None):
    """On this rank of ``mesh`` (one rank where it is None): ``name``'s
    forward logits, loss and gradients, one training step's loss and
    norm, ``adamw_update`` on the gradients ``given`` (this run's own
    where None) and the greedy tokens, each gathered whole (a collective
    on every rank)."""
    cfg = case_cfg(name)
    fsdp = CASES[name][3]
    rules = make_rules(cfg, mesh)
    if fsdp:
        rules = with_fsdp(rules)
    pspecs = lm.param_specs(cfg, rules)
    rows = P(tuple(rules.batch_axes))
    local = {k: local_shard(v, rows, rules) for k, v in torch_batch(batch).items()}
    fn = lambda p, bt: lm.train_loss(p, bt, cfg, rules)  # noqa: E731
    params = shard_tree(full_params(cfg, leaves), pspecs, rules)
    out = {"block": attention.head_block(cfg.n_heads, rules),
           "shapes": {n: tuple(t.shape) for n, t in tree_flatten_with_names(params)}}
    if not fsdp:
        with torch.no_grad():
            logits, _ = lm.forward(params, local["tokens"][:, :-1], cfg, rules,
                                   enc_in=local.get("enc"))
        out["logits"] = gather_shard(gather_over_model(logits, 2, rules, cfg.vocab_padded),
                                     rows, rules).numpy()
    kw = {"specs": pspecs, "rules": rules} if fsdp else {}
    loss, grads = loss_and_grads(fn, params, local, cast_bf16=False, **kw)
    average_over_batch_(grads, rules, pspecs if fsdp else None)
    out["loss"] = float(loss)
    out["grads"] = _numpy(gather_tree(tree_unflatten(params, grads), pspecs, rules))
    params = shard_tree(full_params(cfg, leaves), pspecs, rules)
    step = make_train_step(fn, OPT, cast_bf16=False, param_specs=pspecs, rules=rules)
    _, _, metrics = step(params, init_opt_state(params, pspecs, rules), local)
    out["step_loss"], out["grad_norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
    params = shard_tree(full_params(cfg, leaves), pspecs, rules)
    given = out["grads"] if given is None else given
    grads = shard_tree(tree_unflatten(params, [torch.from_numpy(g) for g in given]), pspecs,
                       rules)
    with torch.no_grad():
        adamw_update(OPT, params, grads, init_opt_state(params, pspecs, rules), specs=pspecs,
                     rules=rules)
    out["params_given"] = _numpy(gather_tree(params, pspecs, rules))
    if not fsdp:
        params = shard_tree(full_params(cfg, leaves), pspecs, rules)
        eng = Engine(params, cfg, ServeConfig(max_new_tokens=NEW), device="cpu", rules=rules)
        out["tokens"] = eng.generate(prompts, enc=enc)
    return out


def job_cases(mesh, names, inputs: dict):
    """Every case of ``names`` on this rank; the results on rank 0, each
    rank's head block and leaf shapes on every rank."""
    out = {}
    for name in names:
        res = run_case(mesh, name, *inputs[name])
        keep = dist.get_rank() == 0
        out[name] = res if keep else {"block": res["block"], "shapes": res["shapes"]}
    return out


def job_blocks(mesh):
    """``local_shard`` / ``gather_shard`` of leaves cut into uneven and
    empty ``Blocks``, beside a plain data split, and
    ``gather_over_model(count=)``."""
    rules = make_rules(configs.smoke("granite-3-2b"), mesh)
    out = {}
    for count, width in ((5, 3), (2, 4), (7, 1)):
        full = torch.arange(6.0 * count * width).reshape(6, count * width)
        for spec in (P(None, Blocks("model", count, width)), P("data", Blocks("model", count,
                                                                              width))):
            part = local_shard(full, spec, rules)
            out[(count, width, spec[0] is not None)] = (
                tuple(part.shape), bool(torch.equal(gather_shard(part, spec, rules), full)))
    lo, hi = split_block(5, rules.model_size, model_index(rules))
    heads = torch.arange(2 * 5.0).reshape(2, 5)
    out["over_model"] = gather_over_model(heads[:, lo:hi], 1, rules, 5).numpy()
    return out


def job_save(mesh, leaves: dict, ckpt_dir: str):
    """``CKPT_CASE``'s parameters after one step, saved from this mesh; the
    state gathered (rank 0)."""
    from repro_torch.train import checkpoint as ckpt_lib

    cfg = case_cfg(CKPT_CASE)
    rules, pspecs = make_rules(cfg, mesh), lm.param_specs(cfg)
    params = shard_tree(full_params(cfg, leaves), pspecs, rules)
    batch = {k: local_shard(v, P(tuple(rules.batch_axes)), rules)
             for k, v in torch_batch(batch_of(cfg)).items()}
    step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg, rules), OPT, cast_bf16=False,
                           param_specs=pspecs, rules=rules)
    step(params, init_opt_state(params, pspecs, rules), batch)
    ckpt_lib.save(ckpt_dir, 1, params, specs=pspecs, rules=rules, block=True)
    full = _numpy(gather_tree(params, pspecs, rules))
    return full if dist.get_rank() == 0 else None


def job_restore(mesh, ckpt_dir: str):
    """The checkpoint restored on this mesh (this rank's shards), gathered
    (rank 0)."""
    from repro_torch.train import checkpoint as ckpt_lib

    cfg = case_cfg(CKPT_CASE)
    rules, pspecs = make_rules(cfg, mesh), lm.param_specs(cfg)
    like = lm.init_params(cfg, seed=1, dtype=torch.float32, device="cpu", rules=rules)
    got = ckpt_lib.restore(ckpt_dir, 1, like, device="cpu", specs=pspecs, rules=rules)
    assert [a.shape for a in tree_leaves(got)] == [a.shape for a in tree_leaves(like)]
    full = _numpy(gather_tree(got, pspecs, rules))
    return full if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# the inputs, the one-rank runs and the JAX package's
# ---------------------------------------------------------------------------


def batch_of(cfg) -> dict:
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
             .astype(np.int32)}
    if cfg.enc_dec:
        batch["enc"] = (np.random.default_rng(1).standard_normal((B, cfg.enc_len, cfg.d_model))
                        .astype(np.float32))
    return batch


@functools.cache
def reference(name: str):
    """(the port's named numpy leaves of the JAX package's float32 weights,
    the batch, the prompts and frames, the JAX package's one-device forward
    logits and loss)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.models import lm as j_lm
    from repro_torch.models.convert import params_from_numpy

    arch, overrides, _, _ = CASES[name]
    jcfg = j_configs.smoke(arch).with_overrides(dtype="float32", **overrides)
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), case_cfg(name), device="cpu")
    leaves = {n: t.numpy() for n, t in tree_flatten_with_names(tp)}
    batch = batch_of(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jax.jit(lambda p, b: j_lm.forward(p, b["tokens"][:, :-1], jcfg,
                                                  enc_in=b.get("enc")))(jp, jb)
    loss = float(jax.jit(lambda p, b: j_lm.train_loss(p, b, jcfg))(jp, jb))
    prompts = batch["tokens"][:, :S // 2].astype(np.int64)
    enc = batch.get("enc")
    return leaves, batch, prompts, enc, np.asarray(logits), loss


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every grid's ranks (the (1, 3) set first: it saves the checkpoint
    the (1, 4) set restores), each case's one-rank run and the JAX
    package's."""
    tmp = tmp_path_factory.mktemp("heads")
    inputs = {name: reference(name)[:4] for name in CASES}
    one = {name: run_case(None, name, *inputs[name]) for name in CASES}
    inputs = {name: (*inputs[name], one[name]["grads"]) for name in CASES}
    ckpt = str(tmp / "ckpt")
    grids = {}
    for grid in GRIDS:
        names = [n for n, c in CASES.items() if c[2] == grid]
        jobs = [("cases", job_cases, {"names": names, "inputs": {n: inputs[n] for n in names}}),
                ("blocks", job_blocks, {})]
        if grid == (1, 3):
            jobs.append(("save", job_save, {"leaves": inputs[CKPT_CASE][0], "ckpt_dir": ckpt}))
        if grid == (1, 4):
            jobs.append(("restore", job_restore, {"ckpt_dir": ckpt}))
        grids[grid] = run_grid(grid, jobs, tmp / f"grid{grid_id(grid)}")
    return grids, one, ckpt


def _ranks(runs, name):
    grids, one, _ = runs
    return grids[CASES[name][2]], one[name]


def _norm_close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        diff = float(np.linalg.norm(np.asarray(g, np.float64) - np.asarray(w, np.float64)))
        assert diff <= tol * float(np.linalg.norm(w)) + 1e-30, (what, i, diff)


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_block(runs, name):
    ranks, _ = _ranks(runs, name)
    cfg = case_cfg(name)
    m = CASES[name][2][1]
    for r, res in enumerate(ranks):
        lo, hi = res["cases"][name]["block"]
        assert (lo, hi) == split_block(cfg.n_heads, m, r % m)
        shapes = res["cases"][name]["shapes"]
        wq = next(s for n, s in shapes.items() if n.endswith("attn/wq"))
        assert wq[-1] == (hi - lo) * cfg.head_dim
    if name.startswith("granite-2h"):  # rank 2 of each data row holds no head
        assert ranks[2]["cases"][name]["block"] == (2, 2)
        assert next(s for n, s in ranks[2]["cases"][name]["shapes"].items()
                    if n.endswith("attn/wo"))[0] == 0


@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradients_equal_one_rank(runs, name):
    ranks, one = _ranks(runs, name)
    got = ranks[0]["cases"][name]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
    _norm_close(got["grads"], one["grads"], GRAD_NORM_TOL, "grads")
    np.testing.assert_allclose(got["step_loss"], one["step_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
    _norm_close(got["params_given"], one["params_given"], STEP_NORM_TOL, "params_given")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if not c[3]])
def test_logits_and_tokens_equal_one_rank(runs, name):
    ranks, one = _ranks(runs, name)
    got = ranks[0]["cases"][name]
    _norm_close(list(got["logits"]), list(one["logits"]), GRAD_NORM_TOL, "logits")
    np.testing.assert_array_equal(got["tokens"], one["tokens"])


@pytest.mark.parametrize("name", CASES)
def test_logits_and_loss_match_the_reference(runs, name):
    ranks, _ = _ranks(runs, name)
    *_, logits, loss = reference(name)
    got = ranks[0]["cases"][name]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    if "logits" in got:
        np.testing.assert_allclose(got["logits"], logits, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_uneven_and_empty_blocks_round_trip(runs, grid):
    grids, _, _ = runs
    m = grid[1]
    for r, res in enumerate(grids[grid]):
        blocks = res["blocks"]
        np.testing.assert_array_equal(blocks.pop("over_model"), np.arange(10.0).reshape(2, 5))
        for (count, width, data), (shape, equal) in blocks.items():
            lo, hi = split_block(count, m, r % m)
            assert equal and shape == (6 // grid[0] if data else 6, (hi - lo) * width)


def test_checkpoint_saved_at_1x3_restores_on_one_rank_and_at_1x4(runs):
    from repro_torch.train import checkpoint as ckpt_lib

    grids, _, ckpt = runs
    saved = grids[(1, 3)][0]["save"]
    like = lm.init_params(case_cfg(CKPT_CASE), seed=1, dtype=torch.float32, device="cpu")
    one = _numpy(tree_leaves(ckpt_lib.restore(ckpt, 1, like, device="cpu")))
    for got in (one, grids[(1, 4)][0]["restore"]):
        assert len(got) == len(saved)
        for a, b in zip(got, saved):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the dry run at 16 model ranks
# ---------------------------------------------------------------------------

#: arch -> the smoke config's overrides: the full config's q and KV heads
#: (and llama4's 16 experts, so that 16 model ranks split them).
DRY_HEADS = {"yi-34b": dict(n_heads=56, n_kv_heads=8),
             "llama4-scout-17b-a16e": dict(n_heads=40, n_kv_heads=8, n_experts=16),
             "whisper-base": dict(n_heads=8, n_kv_heads=8)}


def _replicated_bytes(cell, cfg) -> int:
    """The bytes of a decode cell's arguments that every model rank holds
    whole: the parameters and the caches whose specs name no ``model``
    (whisper's cross K/V), the token and the positions."""
    params, token, caches, pos = cell.args
    whole = [t for t, s in zip(tree_leaves(params), tree_leaves(lm.param_specs(cfg)))
             if "model" not in s]
    whole += [t for t, s in zip(tree_leaves(caches), tree_leaves(lm.cache_specs(cfg, cell.rules)))
              if "model" not in s]
    return dryrun.argument_bytes(whole) + dryrun.argument_bytes((token, pos))


@pytest.mark.parametrize("arch", DRY_HEADS)
def test_dry_run_at_16_model_ranks_records_each_block(arch):
    cfg = configs.smoke(arch).with_overrides(**DRY_HEADS[arch])
    shape = ShapeSpec("d", "decode", 32, 2)
    one = dryrun.argument_bytes(specs.make_cell(cfg, shape, None).args)
    total, replicated = 0, None
    for rank in range(16):
        with fake_world((1, 16), NAMES, rank=rank) as mesh:
            cell = specs.make_cell(cfg, shape, mesh)
            assert cell.rules.model_axis == "model"
            total += dryrun.argument_bytes(cell.args)
            rank_replicated = _replicated_bytes(cell, cfg)
            replicated = rank_replicated if replicated is None else replicated
            assert rank_replicated == replicated
            if rank in (0, 1, 15):
                rec = dryrun.trace_cell(cell, mesh, rank=rank, verbose=False)
                assert rec["status"] == "ok", rec
                assert rec["head_block"] == list(split_block(cfg.n_heads, 16, rank))
                assert rec["n_collective_ops"] > 0
    assert total == one + 15 * replicated

"""The sharding specs of ``repro_torch`` against the JAX package's, and the
parts of sharded training that are not the grids of ``test_torch_tp.py``:
the collectives' gradients, the split leaves' shards, data parallelism
over the SSM and encoder-decoder families, and checkpoints that move
between meshes.

* ``ShardingRules.spec`` on the stub meshes of ``tests/test_dist_unit.py``
  (every kind, non-dividing axes, context parallelism, heads unsharded,
  pod axes), ``make_rules``' MoE divisibility, ``lm.param_specs`` and
  ``lm.cache_specs`` for every smoke config (the reference's stack axis
  stripped, a PartitionSpec read as a tuple), ``zero1_spec_for`` and
  ``opt_state_specs`` on the inputs of ``tests/test_train.py::
  test_zero1_specs``, and ``make_production_mesh``'s shape and names:
  equal, not close.
* The regions' functions on a (2, 2) grid of gloo ranks: values and
  gradients exact (small integers).
* Data parallelism over the mamba2 and whisper smoke configs on a (2, 1)
  grid against one rank: the loss within rtol 1e-5 and each gradient
  within 1e-5 of its norm (float32 rounding of a mean split over ranks).
* ``local_shard``/``gather_shard`` of a split leaf (Mamba2's ``w_zx``,
  z | x) on a (1, 2) grid: each rank holds its heads' columns of z and of
  x, and the gather gives the leaf back: exact.
* A checkpoint written at (1, 2) restores at (2, 1), ZeRO-1 slices and
  all, and on one device: bit for bit (the port's counterpart of
  ``tests/test_elastic.py``), for granite and for mamba2, whose ``w_zx``
  comes back in the one-rank column order.

The ranks run jobs of ``test_torch_tp.py`` (its ``run_grid``), which
imports no JAX.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as j_configs
from repro.dist import sharding as j_sharding
from repro.models import lm as j_lm
from repro.train import optimizer as j_opt
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P, ShardingRules, make_rules
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as t_opt
from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves
from test_torch_tp import (
    dp_run,
    job_dp,
    job_regions,
    job_restore,
    job_save,
    job_split_leaf,
    run_grid,
)

LOSS_RTOL, GRAD_NORM_TOL = 1e-5, 1e-5


def _stub_mesh(**axes):
    """Axis-size stub readable by both packages' rules and ZeRO-1 helpers."""
    return types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes),
                                 devices=np.empty(tuple(axes.values())))


def _plain(tree, strip_stack=False):
    """A tree of specs as plain Python: a spec becomes ("P", its entries),
    the leading stack axis dropped when ``strip_stack``."""
    if isinstance(tree, (JP, P)):
        # a one-name tuple entry is that name (as JAX normalizes it)
        entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tree)
        return ("P", entries[1:] if strip_stack else entries)
    if isinstance(tree, dict):
        return {k: _plain(v, strip_stack) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v, strip_stack) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_plain(v, strip_stack) for v in tree)
    raise TypeError(type(tree))


# -- ShardingRules.spec and make_rules ------------------------------------------------

KINDS = ("act", "ffn", "logits", "heads", "kv_heads", "mla_cache", "other")
SHAPES = ((8, 32, 64), (6, 32, 3, 16), (8, 32, 4, 16), (8, 32, 2, 16), (8, 32, 512), (7, 3),
          (8, 33, 5), (16,))
RULES = (
    dict(axes=dict(data=4, model=2), batch_axes=("data",), model_axis="model"),
    dict(axes=dict(data=4, model=2), batch_axes=("data",), model_axis="model",
         context_parallel=True, shard_heads=False),
    dict(axes=dict(data=4, model=2), batch_axes=("data",), model_axis="model",
         context_parallel=True),
    dict(axes=dict(data=4, model=2), batch_axes=("data",), model_axis="model", shard_heads=False),
    dict(axes=dict(pod=2, data=2, model=4), batch_axes=("pod", "data"), model_axis="model"),
    dict(axes=dict(data=1, model=1), batch_axes=(), model_axis=None),
    dict(axes=dict(data=3, model=8), batch_axes=("data",), model_axis="model"),
)


@pytest.mark.parametrize("case", range(len(RULES)))
def test_spec_matches_reference(case):
    kw = dict(RULES[case])
    axes = kw.pop("axes")
    got = ShardingRules(mesh=_stub_mesh(**axes), **kw)
    want = j_sharding.ShardingRules(mesh=_stub_mesh(**axes), **kw)
    assert (got.model_size, got.batch_shards) == (want.model_size, want.batch_shards)
    for kind in KINDS:
        for shape in SHAPES:
            assert _plain(got.spec(shape, kind)) == _plain(want.spec(shape, kind)), (kind, shape)


def test_spec_cases_of_the_reference_tests():
    rules = ShardingRules(mesh=_stub_mesh(data=4, model=2), batch_axes=("data",),
                          model_axis="model")
    assert rules.spec((8, 32, 128), "ffn") == (("data",), None, "model")
    assert rules.spec((6, 32, 3, 16), "heads") == (None, None, None, None)
    cp = ShardingRules(mesh=_stub_mesh(data=4, model=2), batch_axes=("data",),
                       model_axis="model", context_parallel=True, shard_heads=False)
    assert cp.spec((8, 32, 64), "act") == (("data",), "model", None)
    assert isinstance(rules.spec((8, 32, 64), "act"), P)


def test_act_is_the_identity():
    x = torch.ones((2, 8, 16))
    rules = ShardingRules(mesh=_stub_mesh(data=2, model=2), batch_axes=("data",),
                          model_axis="model")
    assert rules.act(x, "act") is x and sharding.NO_SHARDING.act(x, "ffn") is x


@pytest.mark.parametrize("n_experts,model,want", [(6, 4, None), (8, 4, "model"), (4, 2, "model"),
                                                  (3, 2, None)])
def test_make_rules_moe_divisibility_matches_reference(n_experts, model, want):
    mesh = _stub_mesh(data=2, model=model)
    got = make_rules(configs.smoke("llama4-scout-17b-a16e").with_overrides(n_experts=n_experts),
                     mesh)
    ref = j_sharding.make_rules(
        j_configs.smoke("llama4-scout-17b-a16e").with_overrides(n_experts=n_experts), mesh)
    assert got.model_axis == ref.model_axis == want
    assert got.batch_axes == ref.batch_axes == ("data",)


def test_explicit_path_refuses_what_it_does_not_run():
    """Under a model axis the heads sharded, or the sequence with the heads
    whole (the reference's ``cp_seq`` pair); ``shard_heads=False`` alone
    and ``context_parallel=True`` with heads sharded are refused."""
    stub = _stub_mesh(data=1, model=2)
    for kw in (dict(shard_heads=False), dict(context_parallel=True)):
        with pytest.raises(NotImplementedError, match="explicit tensor-parallel"):
            sharding.check_explicit(ShardingRules(mesh=stub, model_axis="model", **kw))
    sharding.check_explicit(ShardingRules(mesh=stub, model_axis="model", context_parallel=True,
                                          shard_heads=False))
    sharding.check_explicit(ShardingRules(mesh=stub, batch_axes=("data",), shard_heads=False))


def test_explicit_path_accepts_fsdp_under_the_reference_defaults():
    """FSDP (the reference's train cell: ``fsdp_axes``) runs under a model
    axis with heads sharded and no context parallelism, and under context
    parallelism with the heads whole; the other two settings are refused
    with it as without it."""
    stub = _stub_mesh(data=2, model=2)
    rules = ShardingRules(mesh=stub, batch_axes=("data",), model_axis="model",
                          fsdp_axes=("data",))
    sharding.check_explicit(rules)
    sharding.check_explicit(dataclasses.replace(rules, context_parallel=True, shard_heads=False))
    for kw in (dict(shard_heads=False), dict(context_parallel=True)):
        with pytest.raises(NotImplementedError, match="explicit tensor-parallel"):
            sharding.check_explicit(dataclasses.replace(rules, **kw))


# -- the specs of the parameters, the caches and the moments ---------------------------


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_reference(arch):
    tcfg, jcfg = configs.smoke(arch), j_configs.smoke(arch)
    got, want = _plain(lm.param_specs(tcfg)), j_lm.param_specs(jcfg)
    stacked = {"groups", "enc_groups"}
    assert set(got) == set(want)
    for key, spec in want.items():
        if key in stacked:
            one = _plain(spec, strip_stack=True)
            n = tcfg.n_groups if key == "groups" else tcfg.n_enc_layers
            assert got[key] == [one] * n, key
        else:
            assert got[key] == _plain(spec), key
    # one spec per parameter, shaped like it
    params = lm.init_params(tcfg, device="cpu")
    specs = tree_leaves(lm.param_specs(tcfg))
    assert len(specs) == len(tree_leaves(params))
    assert all(len(s) == p.ndim for s, p in zip(specs, tree_leaves(params)))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_specs_match_reference(arch):
    tcfg, jcfg = configs.smoke(arch), j_configs.smoke(arch)
    for axes, batch_axes, model_axis in ((dict(data=2, model=2), ("data",), "model"),
                                         (dict(data=1, model=1), (), None)):
        kw = dict(batch_axes=batch_axes, model_axis=model_axis)
        got = _plain(lm.cache_specs(tcfg, ShardingRules(mesh=_stub_mesh(**axes), **kw)))
        want = j_lm.cache_specs(jcfg, j_sharding.ShardingRules(mesh=_stub_mesh(**axes), **kw))
        assert set(got) == set(want)
        assert got["groups"] == [_plain(want["groups"], strip_stack=True)] * tcfg.n_groups
        for key in want:
            if key != "groups":
                assert got[key] == _plain(want[key]), key
    caches = lm.init_cache(tcfg, 2, 4, device="cpu")
    specs = tree_leaves(lm.cache_specs(tcfg, sharding.NO_SHARDING))
    assert len(specs) == len(tree_leaves(caches))


def test_zero1_spec_for_matches_reference():
    sizes = {"data": 16, "model": 16}
    cases = (((4096, 1024), (None, "model")), ((4096, 1024), ("data", "model")), ((7,), (None,)),
             ((32, 48), (None, None)), ((5, 32), ("model", None)), ((16, 16, 16), ("model",)))
    for shape, entries in cases:
        got = sharding.zero1_spec_for(shape, P(*entries), ("data",), sizes)
        want = j_opt.zero1_spec_for(shape, JP(*entries), ("data",), sizes)
        assert tuple(got) == tuple(want), (shape, entries)
    assert sharding.zero1_spec_for((4096, 1024), P(None, "model"), ("data",), sizes) == \
        ("data", "model")
    two = {"pod": 2, "data": 4, "model": 2}
    assert tuple(sharding.zero1_spec_for((16, 8), P(None, "model"), ("pod", "data"), two)) == \
        tuple(j_opt.zero1_spec_for((16, 8), JP(None, "model"), ("pod", "data"), two))


def test_opt_state_specs_match_reference():
    shapes = {"a": jax.ShapeDtypeStruct((4096, 1024), np.float32),
              "b": [jax.ShapeDtypeStruct((7,), np.float32),
                    jax.ShapeDtypeStruct((64, 32), np.float32)]}
    t_specs = {"a": P(None, "model"), "b": [P(None), P(None, None)]}
    j_specs = {"a": JP(None, "model"), "b": [JP(None), JP(None, None)]}
    for axes, zero1 in ((dict(data=16, model=16), True), (dict(data=16, model=16), False),
                        (dict(pod=2, data=4, model=2), True), (dict(data=1, model=4), True)):
        mesh = _stub_mesh(**axes)
        got = t_opt.opt_state_specs(shapes, t_specs, mesh, zero1)
        want = j_opt.opt_state_specs(shapes, j_specs, mesh, zero1)
        assert _plain(got) == _plain(want), axes
    assert t_opt.opt_state_specs(shapes, t_specs)["m"] is t_specs


def test_make_production_mesh_shapes_and_names(monkeypatch):
    calls = []
    monkeypatch.setattr(t_mesh, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: calls.append(
                            (dev, shape, mesh_dim_names)) or "mesh")
    assert t_mesh.make_production_mesh() == "mesh"
    t_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert calls == [("cuda", (16, 16), ("data", "model")),
                     ("cpu", (2, 16, 16), ("pod", "data", "model"))]


# -- the split leaves ---------------------------------------------------------------------


def test_split_leaf_table_names_w_zx():
    specs = dict(tree_flatten_with_names(lm.param_specs(configs.smoke("zamba2-2.7b"))))
    split = sorted({n.rsplit("/", 1)[-1] for n in specs if sharding.split_parts(n) > 1})
    assert split == ["w_zx"]
    assert specs["groups/0/pos0/ssm/w_zx"] == (None, "model")  # the reference's spec, verbatim


# -- on gloo ranks -----------------------------------------------------------------------


def test_region_collectives_and_their_gradients(tmp_path):
    ranks = run_grid((2, 2), [("r", job_regions, {})], tmp_path)
    weights = np.arange(1.0, 9.0).reshape(4, 2)
    full = np.arange(48.0).reshape(8, 6)
    for res in (r["r"] for r in ranks):
        d, m = res["coord"]
        y, grad = res["reduce_from"]
        np.testing.assert_array_equal(y, [2.0 * (20 * d + 3)] * 3)
        np.testing.assert_array_equal(grad, [6.0] * 3)  # identity backward
        np.testing.assert_array_equal(res["copy_to"], [20.0 * d + 3] * 3)  # summed backward
        z, zgrad = res["mean_over_batch"]
        np.testing.assert_array_equal(z, [m + 6.0] * 3)
        np.testing.assert_array_equal(zgrad, [5.0] * 3)
        g, rows_grad = res["gather_batch"]
        np.testing.assert_array_equal(g, [[0, 1], [2, 3], [100, 101], [102, 103]])
        np.testing.assert_array_equal(rows_grad, 2 * weights[2 * d:2 * d + 2])
        idx = 2 * d + m
        np.testing.assert_array_equal(res["local_shard"], full[2 * idx:2 * idx + 2])
        np.testing.assert_array_equal(res["gather_shard"], full)


def test_data_parallel_over_ssm_and_encoder_decoder_equals_one_rank(tmp_path):
    archs = ("mamba2-370m", "whisper-base")
    ranks = run_grid((2, 1), [(a, job_dp, {"arch": a}) for a in archs], tmp_path)
    for arch in archs:
        loss, grads = dp_run(arch)
        for res in ranks:
            got_loss, got_grads = res[arch]
            np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
            for i, (g, w) in enumerate(zip(got_grads, grads)):
                diff = float(np.linalg.norm(g.astype(np.float64) - w))
                assert diff <= GRAD_NORM_TOL * float(np.linalg.norm(w)) + 1e-30, (arch, i)


def test_split_leaf_shards_by_parts(tmp_path):
    """w_zx (d, 2 di) = z | x over 2 model ranks: rank r holds z's and x's
    columns of its heads, and gathers the whole leaf back."""
    ranks = run_grid((1, 2), [("s", job_split_leaf, {})], tmp_path)
    full = np.arange(24.0).reshape(2, 12)  # z: columns 0-5, x: columns 6-11
    for r, res in enumerate(ranks):
        part, back = res["s"]
        want = np.concatenate([full[:, 3 * r:3 * r + 3], full[:, 6 + 3 * r:9 + 3 * r]], axis=1)
        np.testing.assert_array_equal(part, want)
        np.testing.assert_array_equal(back, full)


def test_checkpoint_moves_between_meshes_bit_for_bit(tmp_path):
    """Written at (1, 2) after two steps; restored at (2, 1), where the
    moments are ZeRO-1 slices, and on one device. granite-3-2b and
    mamba2-370m (a split leaf: its ``w_zx`` restores in the one-rank
    column order, near its initial value and far from the order an even
    cut gathered by parts would give)."""
    archs, ckpt = ("granite-3-2b", "mamba2-370m"), lambda a: str(tmp_path / "ckpt" / a)
    saved = run_grid((1, 2), [(a, job_save, {"arch": a, "ckpt_dir": ckpt(a)}) for a in archs],
                     tmp_path / "save")[0]
    moved = run_grid((2, 1), [(a, job_restore, {"arch": a, "ckpt_dir": ckpt(a)}) for a in archs],
                     tmp_path / "restore")[0]
    for arch in archs:
        assert len(saved[arch]) == len(moved[arch])
        for a, b in zip(saved[arch], moved[arch]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        cfg = configs.smoke(arch)
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        like = {"params": params, "opt": t_opt.init_opt_state(params)}
        one = ckpt_lib.restore(ckpt(arch), 2, like, device="cpu")
        for a, b in zip(saved[arch], tree_leaves(one)):
            np.testing.assert_array_equal(a, b.numpy())
        assert int(one["opt"]["step"]) == 2
        if arch == "mamba2-370m":
            w0 = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
            w0 = w0["groups"][0]["pos0"]["ssm"]["w_zx"].numpy()
            w2 = one["params"]["groups"][0]["pos0"]["ssm"]["w_zx"].numpy()
            z0, z1, x0, x1 = np.split(w0, 4, axis=1)
            mixed = np.concatenate([z0, x0, z1, x1], axis=1)
            assert np.linalg.norm(w2 - w0) < 0.1 * np.linalg.norm(w0)
            assert np.linalg.norm(w2 - mixed) > 0.5 * np.linalg.norm(w0)

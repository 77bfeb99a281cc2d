"""Training in the port on the CPU, against the JAX package where both
compute the same thing: ``models.layers.softmax_xent``, ``lm.train_loss``
and its gradients (every ``ARCH_NAMES`` smoke config, MoE's aux
included), rematerialization (``cfg.remat``), ``train.optimizer``
(``schedule``, ``adamw_update``), ``train.trainer`` (``make_train_step``,
``train``, the watchdog, preemption), ``train.checkpoint``,
``train.compression`` over two gloo ranks, ``utils.tree`` and
``launch.train`` (on one device, and on spawned gloo ranks with
``--data-shards``/``--model-shards``). The mirrors of
``tests/test_train.py`` keep its names with ``_port`` added; its
``test_zero1_specs`` is mirrored in ``tests/test_torch_sharding.py``, and
``tests/test_elastic.py``'s restore on another mesh there too (here the
restore on a single device).

Tolerances, each measured on the CPU:

* float32 on both sides: the loss within rtol 1e-5 (measured 9.5e-7 at
  ~7.0), each leaf's gradient within 1e-4 of its reference norm in the 2-norm
  of the difference (measured at most 2.0e-5, llama4);
* ``adamw_update`` on the same gradients: parameters, ``m`` and ``v``
  within rtol 1e-6 and atol 1e-9, float32 rounding of one step's dozen
  operations (measured 4 ulps of the parameters, 8 of ``v``);
* with the bfloat16 compute cast (``cast_bf16``) the gradients of the two
  packages part at bfloat16 rounding, and AdamW's first step,
  ``mhat / sqrt(vhat)`` ~ sign(g), turns a rounding difference near 0 into
  2·lr. So the hold is split: the loss within 0.01 (a third of a bf16 ulp
  at 6.3; measured 5.1e-4) and each leaf's gradient within 5% of its
  reference norm (measured 1.5%), then ``adamw_update`` on the reference's
  gradients, held as above;
* remat against no remat: loss and every gradient bit for bit (the
  recompute replays the forward, MoE routing included);
* the compressed all-reduce against a numpy reckoning of both schemes:
  bit for bit (two ranks: one float32 addition and a division by 2);
* ``launch.train`` on D × M gloo ranks against its one-device run: the
  printed losses within ``BF16_LOSS_ATOL`` (the trainer's bfloat16
  compute copy rounds the model ranks' partial sums apart).
"""

import os
import re
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train.trainer import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.compression import compressed_psum_mean  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    schedule,
)
from repro_torch.train.trainer import (  # noqa: E402
    TrainerConfig,
    Watchdog,
    loss_and_grads,
    make_train_step,
    train,
)
from repro_torch.utils.tree import (  # noqa: E402
    param_bytes,
    param_count,
    stacked_ndims,
    tree_flatten_with_names,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_NORM_TOL = 1e-5, 1e-4
OPT_RTOL, OPT_ATOL = 1e-6, 1e-9
BF16_LOSS_ATOL, BF16_GRAD_NORM_TOL = 1e-2, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_MODELS = {}


def _model(arch, **overrides):
    """(jax cfg, port cfg, jax params, port params) of the smoke config
    with ``overrides``, float32 weights, built once per key."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg = j_configs.smoke(arch).with_overrides(**overrides)
        tcfg = t_configs.smoke(arch).with_overrides(**overrides)
        jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, dtype=jnp.float32))(
            jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def _batch(cfg, b=2, s=8, seed=0):
    """Numpy tokens (B, S+1) and, for whisper, frames (B, enc_len, d_model)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.enc_dec:
        out["enc"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _port_leaves(jax_tree, tcfg):
    """A reference tree of the parameters' structure as the port's leaves."""
    return tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jax_tree), tcfg, device="cpu"))


def _jax_cast(p):
    """The reference trainer's bfloat16 compute copy (``trainer.py:186-192``)."""
    return jax.tree.map(
        lambda w: w.astype(jnp.bfloat16) if w.dtype == jnp.float32 and w.ndim >= 2 else w, p)


def _hold_grads(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.double()
        diff = float((g.double() - w).norm())
        assert diff <= tol * float(w.norm()) + 1e-30, (i, diff, float(w.norm()))


def _hold_opt(tp, ts, jp, js, tcfg):
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for g, w in zip(tree_leaves(got), _port_leaves(want, tcfg)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=OPT_RTOL, atol=OPT_ATOL)
    assert int(ts["step"]) == int(js["step"])


# -- the loss and its gradients --------------------------------------------------


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32) * 3
    logits[..., 500:] = np.finfo(np.float32).min  # the padded vocabulary
    labels = rng.integers(0, 500, (2, 5)).astype(np.int32)
    want = j_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 500)
    got = t_layers.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), 500)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got16 = t_layers.softmax_xent(torch.from_numpy(logits).to(torch.bfloat16),
                                  torch.from_numpy(labels), 500)
    want16 = j_layers.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                                   jnp.asarray(labels), 500)
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-6)


@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
def test_train_loss_and_grads_match_reference(arch):
    """float32 on both sides: the loss (MoE's aux included) and every
    leaf's gradient."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(tcfg)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p, b: j_lm.train_loss(p, b, jcfg)))(
        jp, _jax_batch(batch))
    loss, grads = loss_and_grads(lambda p, b: t_lm.train_loss(p, b, tcfg), tp, _torch_batch(batch),
                                 cast_bf16=False)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL)
    _hold_grads(grads, _port_leaves(grads_j, tcfg), GRAD_NORM_TOL)
    if tcfg.is_moe:
        _, aux = t_lm.forward(tp, _torch_batch(batch)["tokens"][:, :-1], tcfg)
        assert float(aux) > 0


def test_train_loss_adds_the_moe_aux():
    _, tcfg, _, tp = _model("deepseek-v2-lite-16b")
    batch = _torch_batch(_batch(tcfg))
    logits, aux = t_lm.forward(tp, batch["tokens"][:, :-1], tcfg)
    xent = t_layers.softmax_xent(logits, batch["tokens"][:, 1:], tcfg.vocab)
    for coef in (0.0, 0.5):
        got = t_lm.train_loss(tp, batch, tcfg, aux_coef=coef)
        assert float(got) == float(xent + coef * aux)


# -- rematerialization -----------------------------------------------------------


REMAT_CASES = [
    ("granite-3-2b", {"n_layers": 4}, "nothing"),  # 4 groups: superblocks of 2
    ("granite-3-2b", {"n_layers": 4}, "dots"),
    ("granite-3-2b", {"n_layers": 4}, "default"),
    ("granite-3-2b", {"n_layers": 4, "scan_layers": False}, "nothing"),  # per group
    ("deepseek-v2-lite-16b", {"n_layers": 5}, "nothing"),  # prologue + 4 MoE groups
    ("llama4-scout-17b-a16e", {}, "dots"),
    ("zamba2-2.7b", {}, "nothing"),
    ("whisper-base", {}, "nothing"),
    ("mamba2-370m", {"n_layers": 4}, "dots"),
]


@pytest.mark.parametrize("arch,overrides,policy", REMAT_CASES)
def test_remat_gradients_are_bit_equal(arch, overrides, policy, monkeypatch):
    """``cfg.remat`` recomputes the groups in the backward (every group
    layer runs twice) and gives the remat-free loss and gradients bit for
    bit."""
    _, tcfg, _, tp = _model(arch, **overrides)
    batch = _torch_batch(_batch(tcfg, s=10, seed=3))
    runs = {}
    for remat in (False, True):
        cfg = tcfg.with_overrides(remat=remat, remat_policy=policy)
        calls = []
        orig = t_lm._apply_layer
        monkeypatch.setattr(t_lm, "_apply_layer",
                            lambda *a, **k: calls.append(a[1]) or orig(*a, **k))
        runs[remat] = loss_and_grads(lambda p, b: t_lm.train_loss(p, b, cfg), tp, batch,
                                     cast_bf16=False), len(calls)
        monkeypatch.setattr(t_lm, "_apply_layer", orig)
    (loss0, g0), n0 = runs[False]
    (loss1, g1), n1 = runs[True]
    group_layers = tcfg.n_groups * len(t_lm.group_layout(tcfg))
    assert n1 == n0 + group_layers  # the recompute
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_best_outer_is_the_reference_split():
    for g in range(1, 65):
        assert t_lm._best_outer(g) == j_lm._best_outer(g)
    assert t_lm._best_outer(40) == 5  # granite-3-2b: 5 superblocks of 8 groups


def test_training_forward_builds_no_caches():
    _, tcfg, _, tp = _model("granite-3-2b")
    x = torch.zeros((1, 3, tcfg.d_model))
    with pytest.raises(ValueError, match="no caches"):
        t_lm._backbone(tp, x, tcfg, torch.zeros((1, 3), dtype=torch.long), want_cache=True,
                       train=True)


# -- the optimizer ---------------------------------------------------------------


def test_schedule_matches_reference():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = j_opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in range(0, 131, 3):
        got = schedule(cfg, torch.tensor(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j_opt.schedule(jcfg, jnp.asarray(step))),
                                   rtol=1e-6)


def test_schedule_warmup_and_decay_port():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(schedule(cfg, torch.tensor(10))) - 1e-3) < 1e-9
    assert float(schedule(cfg, torch.tensor(100))) < 1.1 * cfg.min_lr_frac * cfg.lr


def test_adamw_update_matches_reference():
    """Three steps on granite's smoke tree from the same state and the same
    gradients (the first clipped, the next two not)."""
    jcfg, tcfg, jp, tp = _model("granite-3-2b")
    tp = _clone(tp)
    jo = j_opt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    to = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    js = j_opt.init_opt_state(jp)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        gj = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * (1.0 if i == 0 else 1e-3)), jp)
        gt = params_from_numpy(jax.tree.map(np.asarray, gj), tcfg, device="cpu")
        jp, js, jm = j_opt.adamw_update(jo, jp, gj, js)
        with torch.no_grad():
            tp, ts, tm = adamw_update(to, tp, gt, ts)
        _hold_opt(tp, ts, jp, js, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_adamw_decays_what_the_reference_stacks():
    """Zero gradients: only decay moves a parameter. A group's vector is a
    stacked (G, d) matrix in the reference and decays; a top-level vector
    does not."""
    params = {"groups": [{"ln": torch.ones(4), "w": torch.ones(2, 2)}], "norm": torch.ones(4)}
    assert stacked_ndims(params) == [2, 3, 1]
    grads = tree_map(torch.zeros_like, params)
    with torch.no_grad():
        adamw_update(OptimizerConfig(lr=0.1, warmup_steps=0), params, grads,
                     init_opt_state(params))
    assert float(params["groups"][0]["ln"][0]) < 1 and float(params["groups"][0]["w"][0, 0]) < 1
    assert torch.equal(params["norm"], torch.ones(4))


def test_adamw_updates_in_place_in_chunks(monkeypatch):
    """``CHUNK_NUMEL`` splits the leaves into groups of ``_foreach`` ops
    without changing a bit; a bfloat16 parameter is cast back."""
    from repro_torch.train import optimizer as t_opt

    rng = np.random.default_rng(1)
    base = {"a": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(16).astype(np.float32)),
            "c": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)).to(torch.bfloat16)}
    grads = tree_map(lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)),
                     base)
    out = []
    for chunk in (1 << 28, 20):
        monkeypatch.setattr(t_opt, "CHUNK_NUMEL", chunk)
        p = _clone(base)
        ids = {k: id(v) for k, v in p.items()}
        with torch.no_grad():
            adamw_update(OptimizerConfig(lr=0.1, warmup_steps=0), p, grads, init_opt_state(p))
        assert {k: id(v) for k, v in p.items()} == ids and p["c"].dtype == torch.bfloat16
        out.append(p)
    for k in base:
        assert torch.equal(out[0][k], out[1][k]) and not torch.equal(out[0][k], base[k])


def _quadratic_loss(params, batch):
    return torch.sum((params["w"] - batch["target"]) ** 2)


def test_adamw_converges_quadratic_port():
    params = {"w": torch.ones((4, 4)) * 5.0}
    opt = init_opt_state(params)
    cfg = OptimizerConfig(lr=0.2, warmup_steps=0, total_steps=300, weight_decay=0.0)
    batch = {"target": torch.zeros((4, 4))}
    step = make_train_step(_quadratic_loss, cfg, cast_bf16=False)
    for _ in range(300):
        params, opt, metrics = step(params, opt, batch)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_accumulation_equivalence_port():
    """accum_steps=4 gives the update of one big batch, and the
    reference's accumulated update."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 8)).astype(np.float32)

    def loss(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    out = {}
    for accum in (1, 4):
        p = {"w": torch.from_numpy(w.copy())}
        out[accum], _, _ = make_train_step(loss, cfg, cast_bf16=False, accum_steps=accum)(
            p, init_opt_state(p), batch)
    np.testing.assert_allclose(out[1]["w"].numpy(), out[4]["w"].numpy(), atol=1e-5)
    jp, _, _ = j_make_train_step(
        lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
        j_opt.OptimizerConfig(lr=1e-2, warmup_steps=0), cast_bf16=False, accum_steps=4)(
        {"w": jnp.asarray(w)}, j_opt.init_opt_state({"w": jnp.asarray(w)}),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    np.testing.assert_allclose(out[4]["w"].numpy(), np.asarray(jp["w"]), rtol=OPT_RTOL,
                               atol=1e-8)


def test_train_step_float32_matches_reference():
    """``cast_bf16=False``: the compute stays float32, so the updated
    parameters themselves are held (one step, granite smoke, and the
    reference's two microbatches)."""
    jcfg, tcfg, jp, tp = _model("granite-3-2b")
    batch = _batch(tcfg, b=4)
    jo = j_opt.OptimizerConfig(lr=1e-3, warmup_steps=0)
    for accum in (1, 2):
        jstep = jax.jit(j_make_train_step(lambda p, b: j_lm.train_loss(p, b, jcfg), jo,
                                          cast_bf16=False, accum_steps=accum))
        jp1, js1, jm = jstep(jp, j_opt.init_opt_state(jp), _jax_batch(batch))
        tp1 = _clone(tp)
        tstep = make_train_step(lambda p, b: t_lm.train_loss(p, b, tcfg),
                                OptimizerConfig(lr=1e-3, warmup_steps=0), cast_bf16=False,
                                accum_steps=accum)
        tp1, ts1, tm = tstep(tp1, init_opt_state(tp1), _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        _hold_grads(tree_leaves(ts1["m"]), _port_leaves(js1["m"], tcfg), GRAD_NORM_TOL)
        # The first step moves each weight by lr * g / (|g| + eps) ~ lr * sign(g)
        # (g the clipped gradient): within 1e-3 of lr where |g| > 1e3 * eps,
        # within the step's reach, 2 * lr, where a gradient's rounding can
        # move g / (|g| + eps) (measured: 1 weight of 4096, by 2.2e-3 of lr).
        lr, near0 = 1e-3, 0
        for g, w, m in zip(tree_leaves(tp1), _port_leaves(jp1, tcfg),
                           _port_leaves(js1["m"], tcfg)):
            diff, small = (g - w).abs().numpy(), (m.abs() <= (1 - jo.b1) * 1e3 * jo.eps).numpy()
            assert diff[~small].max(initial=0) <= 1e-3 * lr
            assert diff[small].max(initial=0) <= 2 * lr
            near0 += int((small & (diff > 1e-3 * lr)).sum())
        assert near0 <= 1e-3 * param_count(tp)


def test_train_step_cast_bf16_split_hold():
    """``cast_bf16=True`` (granite smoke): the loss and each leaf's
    gradient within bfloat16 tolerances of the reference's; then
    ``adamw_update`` on the reference's own gradients, held tight; then
    ``make_train_step`` is exactly those two."""
    jcfg, tcfg, jp, tp = _model("granite-3-2b")
    batch = _batch(tcfg, b=4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm.train_loss(_jax_cast(p), b, jcfg)))(jp, _jax_batch(batch))
    fn = lambda p, b: t_lm.train_loss(p, b, tcfg)  # noqa: E731
    loss, grads = loss_and_grads(fn, tp, _torch_batch(batch), cast_bf16=True)
    assert abs(float(loss) - float(loss_j)) <= BF16_LOSS_ATOL
    _hold_grads(grads, _port_leaves(grads_j, tcfg), BF16_GRAD_NORM_TOL)
    assert all(g.dtype == torch.float32 for g in grads)  # on the float32 masters

    jo, to = j_opt.OptimizerConfig(lr=1e-3), OptimizerConfig(lr=1e-3)
    jp1, js1, _ = j_opt.adamw_update(jo, jp, grads_j, j_opt.init_opt_state(jp))
    tp1 = _clone(tp)
    with torch.no_grad():
        tp1, ts1, _ = adamw_update(to, tp1, params_from_numpy(
            jax.tree.map(np.asarray, grads_j), tcfg, device="cpu"), init_opt_state(tp1))
    _hold_opt(tp1, ts1, jp1, js1, tcfg)

    tp2, tp3 = _clone(tp), _clone(tp)
    tp2, _, m = make_train_step(fn, to)(tp2, init_opt_state(tp2), _torch_batch(batch))
    assert torch.equal(m["loss"], loss)
    with torch.no_grad():
        adamw_update(to, tp3, tree_unflatten(tp, grads), init_opt_state(tp3))
    for a, b in zip(tree_leaves(tp2), tree_leaves(tp3)):
        assert torch.equal(a, b)


# -- checkpoints -----------------------------------------------------------------


def test_checkpoint_roundtrip_port(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 7, tree, block=True)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), 7, tree, device="cpu")
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_keep_k_port(tmp_path):
    tree = {"a": torch.zeros((2,))}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2, block=True)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]


def test_checkpoint_bf16_round_trip_is_bit_exact(tmp_path):
    """bfloat16 leaves (stored as their uint16 bits), a list of groups, a
    0-dim step, NaN and -0 included."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).to(torch.bfloat16)
    w[0, 0], w[0, 1] = float("nan"), -0.0
    tree = {"params": {"groups": [{"w": w}, {"w": w * 3}], "norm": torch.ones(7)},
            "opt": {"step": torch.tensor(5, dtype=torch.int64)}}
    ckpt.save(str(tmp_path), 3, tree, block=True)
    import json

    meta = json.load(open(tmp_path / "step_00000003" / "meta.json"))
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in meta["leaves"]}
    assert dtypes["params/groups/1/w"] == "bfloat16" and dtypes["opt/step"] == "int64"
    assert np.load(tmp_path / "step_00000003" / "params_groups_1_w.npy").dtype == np.uint16
    got = ckpt.restore(str(tmp_path), 3, tree, device="cpu")
    for (name, a), (_, b) in zip(tree_flatten_with_names(got), tree_flatten_with_names(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name


def test_checkpoint_restore_on_a_single_device(tmp_path):
    """``tests/test_elastic.py``'s restore, on one device: a checkpoint
    restores into a tree of zeros of its structure, where asked."""
    ckpt.save(str(tmp_path), 3, {"w": torch.arange(64.0).reshape(8, 8)}, block=True)
    got = ckpt.restore(str(tmp_path), 3, {"w": torch.zeros((8, 8))}, device="cpu")
    assert got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(64.0).reshape(8, 8))
    with pytest.raises(ValueError, match="stored"):
        ckpt.restore(str(tmp_path), 3, {"w": torch.zeros((4, 8))}, device="cpu")


def test_checkpoint_sees_only_complete_directories(tmp_path):
    ckpt.save(str(tmp_path), 2, {"a": torch.zeros(2)}, block=True)
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")  # no meta.json: torn
    assert ckpt.all_steps(str(tmp_path)) == [2] and ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_copies_before_it_returns(tmp_path):
    """The trainer updates the parameters in place after ``save``: what is
    written is the value at the call."""
    w = torch.ones(4)
    th = ckpt.save(str(tmp_path), 1, {"w": w})
    w.add_(1)
    th.join()
    assert torch.equal(ckpt.restore(str(tmp_path), 1, {"w": w}, device="cpu")["w"], torch.ones(4))


# -- the loop ----------------------------------------------------------------------


def test_train_resume_from_checkpoint_port(tmp_path):
    """Kill-and-restart: the second run must resume, not restart."""

    def batch_fn(step):
        return {"target": torch.zeros((2, 2))}

    tcfg = TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100,
                         opt=OptimizerConfig(lr=0.05, warmup_steps=0, weight_decay=0.0))
    p1, _, hist1 = train({"w": torch.ones((2, 2)) * 3.0}, _quadratic_loss, batch_fn, tcfg)
    assert ckpt.latest_step(str(tmp_path)) == 6

    p2, _, hist2 = train({"w": torch.ones((2, 2)) * 3.0}, _quadratic_loss, batch_fn, tcfg)
    assert hist2 == []
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy())

    tcfg2 = TrainerConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100,
                          opt=tcfg.opt)
    _, _, hist3 = train({"w": torch.ones((2, 2)) * 3.0}, _quadratic_loss, batch_fn, tcfg2)
    assert [h["step"] for h in hist3] == [6, 7, 8, 9]


def test_resumed_lm_run_equals_uninterrupted(tmp_path):
    """granite smoke, 6 steps of ``lm.train_loss`` on a seeded stream: a
    run stopped after step 3 and resumed is bit for bit the uninterrupted
    run on the CPU (losses and weights)."""
    from repro_torch.data.synthetic import TokenStream

    _, tcfg, _, tp = _model("granite-3-2b")
    stream = TokenStream(vocab=tcfg.vocab, batch=2, seq_len=8, seed=1)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=6)

    def run(total, ckpt_dir):
        cfg = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=3, log_every=100,
                            opt=opt)
        return train(_clone(tp), lambda p, b: t_lm.train_loss(p, b, tcfg),
                     lambda s: {"tokens": stream.tensor_batch_at(s, "cpu")}, cfg)

    whole_p, _, whole = run(6, "")
    run(3, str(tmp_path))
    resumed_p, _, rest = run(6, str(tmp_path))
    assert [h["step"] for h in rest] == [3, 4, 5]
    assert [h["loss"] for h in rest] == [h["loss"] for h in whole[3:]]
    for a, b in zip(tree_leaves(resumed_p), tree_leaves(whole_p)):
        assert torch.equal(a, b)


def test_preemption_checkpoints_and_stops(tmp_path):
    def batch_fn(step):
        return {"target": torch.zeros((2, 2))}

    def hook(step, params, metrics):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    tcfg = TrainerConfig(total_steps=50, ckpt_dir=str(tmp_path), ckpt_every=100, log_every=100)
    _, _, hist = train({"w": torch.ones((2, 2))}, _quadratic_loss, batch_fn, tcfg, hooks=[hook])
    assert len(hist) == 2 and ckpt.all_steps(str(tmp_path)) == [2]


def test_watchdog_flags_stragglers_port():
    wd = Watchdog(factor=2.0)
    for i in range(5):
        wd.observe(i, 0.1)
    assert not wd.stragglers
    wd.observe(5, 1.0)
    assert wd.stragglers and wd.stragglers[0][0] == 5


# -- trees -------------------------------------------------------------------------


def test_tree_names_counts_and_ranks():
    jcfg, tcfg, jp, tp = _model("whisper-base")
    named = tree_flatten_with_names(tp)
    assert named[0][0] == "embed/head"  # sorted keys, as jax.tree_util
    assert "groups/1/pos0/xattn/wq" in dict(named) and "enc_groups/0/attn/wk" in dict(named)
    j_leaves = jax.tree.leaves(jp)
    assert param_count(tp) == sum(int(np.prod(x.shape)) for x in j_leaves)
    assert param_bytes(tp) == 4 * param_count(tp)
    want = {}
    for name, leaf in tree_flatten_with_names(jax.tree.map(np.asarray, jp)):
        head, _, rest = name.partition("/")
        stacked = head in ("groups", "enc_groups")
        for i in range(leaf.shape[0] if stacked else 1):
            want[f"{head}/{i}/{rest}" if stacked else name] = leaf.ndim
    assert dict(zip([n for n, _ in named], stacked_ndims(tp))) == want


# -- compression over gloo ranks ---------------------------------------------------

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import compressed_psum_mean

    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    rng = np.random.default_rng(rank)
    res = {}
    grads = [{"a": torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(7).astype(np.float32) * 1e-3)]}
             for _ in range(2)]
    for i, g in enumerate(grads):
        res[f"g{i}_a"], res[f"g{i}_b"] = g["a"].numpy().copy(), g["b"][0].numpy().copy()
    mean, _ = compressed_psum_mean(grads[0], scheme="bf16")
    res["bf16_a"], res["bf16_b"] = mean["a"].numpy(), mean["b"][0].numpy()
    err = None
    for i, g in enumerate(grads):
        mean, err = compressed_psum_mean(g, scheme="int8", error_state=err)
        res[f"int8_{i}_a"], res[f"int8_{i}_b"] = mean["a"].numpy(), mean["b"][0].numpy()
        res[f"err_{i}_a"], res[f"err_{i}_b"] = err["a"].numpy(), err["b"][0].numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _bf16_round(x):
    """float32 -> bfloat16 -> float32, round to nearest even, in numpy."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


def _int8_sent(g, err):
    corrected = g + err
    scale = np.float32(max(np.abs(corrected).max(), np.float32(1e-12))) / np.float32(127)
    q = np.clip(np.round(corrected / scale), -127, 127).astype(np.int8)
    sent = q.astype(np.float32) * scale
    return sent, corrected - sent


def test_compressed_psum_mean_on_two_gloo_ranks(tmp_path):
    """bf16 and int8 (two calls, the error fed back) on 2 ranks, against
    numpy: each rank's sent values, their mean, the carried residual."""
    init = "file://" + str(tmp_path / "init")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), init,
                               str(tmp_path / f"rank{r}.npz")], env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for leaf in ("a", "b"):
        want = (_bf16_round(res[0][f"g0_{leaf}"]) + _bf16_round(res[1][f"g0_{leaf}"])) / 2
        for r in range(2):
            np.testing.assert_array_equal(res[r][f"bf16_{leaf}"], want.astype(np.float32))
        errs = [np.zeros_like(res[r][f"g0_{leaf}"]) for r in range(2)]
        for i in range(2):
            sent = []
            for r in range(2):
                s, errs[r] = _int8_sent(res[r][f"g{i}_{leaf}"], errs[r])
                sent.append(s)
                np.testing.assert_array_equal(res[r][f"err_{i}_{leaf}"], errs[r])
            for r in range(2):
                np.testing.assert_array_equal(res[r][f"int8_{i}_{leaf}"], (sent[0] + sent[1]) / 2)


def test_compressed_psum_mean_of_one():
    """No process group: the mean of one rank, the wire's rounding kept."""
    g = {"w": torch.from_numpy(np.random.default_rng(4).standard_normal((3, 3)).astype(np.float32))}
    mean, err = compressed_psum_mean(g, scheme="bf16")
    np.testing.assert_array_equal(mean["w"].numpy(), _bf16_round(g["w"].numpy()))
    assert err is None
    mean, err = compressed_psum_mean(g, scheme="int8")
    sent, resid = _int8_sent(g["w"].numpy(), np.zeros((3, 3), np.float32))
    np.testing.assert_array_equal(mean["w"].numpy(), sent)
    np.testing.assert_array_equal(err["w"].numpy(), resid)
    with pytest.raises(ValueError, match="scheme"):
        compressed_psum_mean(g, scheme="fp8")


# -- the command line ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-base"])
def test_train_cli_on_the_cpu(arch, capsys):
    assert t_launch.main(["--arch", arch, "--preset", "smoke", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(rf"train_done arch={arch} steps=3 loss_first10=(\S+) loss_last10=(\S+)", out)
    assert m and all(np.isfinite(float(v)) for v in m.groups())


def test_train_cli_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_launch.main(["--steps", "1"])


_CLI = ["--arch", "granite-3-2b", "--preset", "smoke", "--steps", "3", "--batch", "4",
        "--seq", "16", "--device", "cpu"]


def _rendezvous(world: int):
    """The ranks' store, hosted here as ``torchrun``'s agent hosts it: a
    ``TCPStore`` on a port the system picked and this process holds for the
    ranks' whole run (``TORCHELASTIC_USE_AGENT_STORE``: every rank a
    client), so no other process can take it between the pick and the
    ranks' start. Returns the store (keep it alive) and its environment."""
    store = torch.distributed.TCPStore("127.0.0.1", 0, world, is_master=True,
                                       wait_for_workers=False)
    return store, {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(store.port),
                   "TORCHELASTIC_USE_AGENT_STORE": "True"}


def _train_done(text: str):
    return re.findall(r"train_done arch=(\S+) steps=(\d+) loss_first10=(\S+) loss_last10=(\S+)",
                      text)


def _cli_on_ranks(cli, data_shards, model_shards, capsys):
    """``launch.train`` on ``data_shards`` · ``model_shards`` processes with
    the ``torchrun`` environment, against its one-device run: rank 0 alone
    prints ``train_done``, with the one-device losses."""
    assert t_launch.main(cli) == 0
    want = _train_done(capsys.readouterr().out)
    world = data_shards * model_shards
    store, rendezvous = _rendezvous(world)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", **rendezvous)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *cli, "--data-shards",
         str(data_shards), "--model-shards", str(model_shards)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        del store
    got = [_train_done(out) for out in outs]
    assert len(got[0]) == 1 and not any(got[1:]), outs
    (arch, steps, first, last), = got[0]
    assert (arch, steps) == want[0][:2]
    for a, b in zip((first, last), want[0][2:]):
        assert abs(float(a) - float(b)) <= BF16_LOSS_ATOL


@pytest.mark.parametrize("model_shards", [1, 2])
def test_train_cli_on_gloo_ranks(model_shards, capsys):
    """``python -m repro_torch.launch.train --data-shards 2 --model-shards
    M --device cpu`` on 2·M processes with the ``torchrun`` environment:
    rank 0 alone prints ``train_done``, with the one-device losses."""
    _cli_on_ranks(_CLI, 2, model_shards, capsys)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b", "whisper-base"])
def test_train_cli_model_shards_over_ssm_hybrid_and_encoder_decoder(arch, capsys):
    """``--model-shards 2`` on the SSM, hybrid and encoder-decoder smoke
    presets (2 processes): the one-device losses."""
    _cli_on_ranks([*_CLI[:1], arch, *_CLI[2:]], 1, 2, capsys)


def test_train_cli_refuses_a_world_of_another_size(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="2 ranks, but the world has 3"):
        t_launch.main(["--data-shards", "2", "--device", "cpu"])


def test_train_cli_frames_are_seeded_by_step():
    cfg = t_configs.smoke("whisper-base")
    a = t_launch.enc_frames(cfg, 2, 0, 3, "cpu")
    assert a.shape == (2, cfg.enc_len, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, t_launch.enc_frames(cfg, 2, 0, 3, "cpu"))
    assert not torch.equal(a, t_launch.enc_frames(cfg, 2, 0, 4, "cpu"))

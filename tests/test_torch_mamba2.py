"""The port's Mamba2 serving path on the CPU against the JAX package:
``models.ssm`` (chunked-SSD prefill, the decode step), ``models.lm``
(forward, prefill, decode_step) and ``serve.engine.Engine``, on the same
weights (``models.convert.params_from_numpy``) and the same seeded numpy
inputs; plus the copied config modules and the port's refusals.

Two sizes: ``configs.smoke("mamba2-370m")`` (2 layers, d_model 64) and a
full-width mixer, ``configs.get("mamba2-370m")`` cut to 1 layer and vocab 512
(d_model 1024, 32 heads of 64 x 128 state).

Tolerance: float32 on both sides, rtol 1e-4 and atol 1e-5 (1e-4 on logits,
whose scale is O(1)). The two packages take the same float32 formulas and
differ in the order of their sums (XLA's and torch's matrix products,
einsums and reductions), a few ulps per sum. Measured on the CPU, the
largest absolute differences are 5.7e-6 (the chunked-SSD output at full
width, entries of size ~1) and 4.1e-6 on logits; every entry stays within
3.7e-6 of its rtol share. Greedy tokens are held equal.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.dist.sharding import NO_SHARDING  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.dist import sharding as t_sharding  # noqa: E402
from repro_torch.kernels import ssd_decode as t_ssd  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

RTOL, ATOL, LOGIT_ATOL = 1e-4, 1e-5, 1e-4
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name):
    if name == "smoke":
        return j_configs.smoke("mamba2-370m"), t_configs.smoke("mamba2-370m")
    kw = dict(n_layers=1, vocab=512)
    return (j_configs.get("mamba2-370m").with_overrides(**kw),
            t_configs.get("mamba2-370m").with_overrides(**kw))


_MODELS = {}


def _model(name):
    """(jax cfg, port cfg, jax params, port params), built once per size."""
    if name not in _MODELS:
        jcfg, tcfg = _cfgs(name)
        jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, dtype=jnp.float32))(
            jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# -- copied modules ----------------------------------------------------------

_COPIED = ("models/config.py",) + tuple(
    f"configs/{f}" for f in sorted(os.listdir(os.path.join(_SRC, "repro", "configs")))
    if f.endswith(".py"))


@pytest.mark.parametrize("path", _COPIED)
def test_copied_config_modules_equal_reference(path):
    with open(os.path.join(_SRC, "repro", path)) as f:
        ref = f.read()
    with open(os.path.join(_SRC, "repro_torch", path)) as f:
        port = f.read()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)


def test_arch_registry_and_presets_match():
    from repro.launch.train import preset_config as j_preset
    from repro_torch.launch.train import preset_config as t_preset

    assert t_configs.ARCH_NAMES == j_configs.ARCH_NAMES
    for arch in j_configs.ARCH_NAMES:
        for preset in ("smoke", "100m", "full"):
            assert (t_preset(arch, preset).__dict__ == j_preset(arch, preset).__dict__)


# -- parameters ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["smoke", "mixer"])
def test_init_params_has_the_reference_layout(name):
    """The port's own init gives the JAX tree's shapes and types, leaf for
    leaf, at the same scales (standard deviations within 10%)."""
    jcfg, tcfg, jp, tp = _model(name)
    mine = t_lm.init_params(tcfg, seed=3, dtype=torch.float32, device="cpu")
    assert len(mine["groups"]) == len(tp["groups"]) == tcfg.n_groups

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in sorted(tree.items()):
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    ours, carried = dict(leaves(mine)), dict(leaves(tp))
    assert ours.keys() == carried.keys()
    for k, v in ours.items():
        assert v.shape == carried[k].shape and v.dtype == carried[k].dtype, k
        sd, sd_ref = float(v.std()), float(carried[k].std())
        assert abs(sd - sd_ref) <= 0.1 * sd_ref + 1e-12, (k, sd, sd_ref)


def test_params_from_numpy_unstacks_the_groups():
    jcfg, tcfg, jp, tp = _model("smoke")
    w = np.asarray(jp["groups"]["pos0"]["ssm"]["w_zx"])
    assert w.shape[0] == tcfg.n_groups
    for g in range(tcfg.n_groups):
        assert np.array_equal(tp["groups"][g]["pos0"]["ssm"]["w_zx"].numpy(), w[g])
    assert np.array_equal(tp["embed"]["head"].numpy(), np.asarray(jp["embed"]["head"]))


# -- the mixer ------------------------------------------------------------------


@pytest.mark.parametrize("name,b,s", [("smoke", 2, 21), ("mixer", 1, 300)])
def test_mamba2_forward_matches(name, b, s):
    """The chunked SSD with S not a chunk multiple (padded by dt = 0)."""
    jcfg, tcfg, jp, tp = _model(name)
    assert s % min(tcfg.ssm_chunk, s) != 0
    x = np.random.default_rng(s).standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"]["pos0"]["ssm"])
    out_j, (st_j, tail_j) = jax.jit(
        lambda p, v: j_ssm.mamba2_forward(p, v, jcfg, NO_SHARDING))(lp_j, jnp.asarray(x))
    out_t, (st_t, tail_t) = t_ssm.mamba2_forward(tp["groups"][0]["pos0"]["ssm"],
                                                 torch.from_numpy(x), tcfg)
    _close(out_t, out_j)
    _close(st_t, st_j)
    _close(tail_t, tail_j)


@pytest.mark.parametrize("name", ["smoke", "mixer"])
def test_mamba2_decode_matches(name):
    """One recurrent step from a random state: out and both new states."""
    jcfg, tcfg, jp, tp = _model(name)
    rng = np.random.default_rng(7)
    b, c = 3, tcfg.d_inner + 2 * tcfg.ssm_state
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    st = rng.standard_normal((b, tcfg.n_ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state)
                             ).astype(np.float32)
    tail = rng.standard_normal((b, tcfg.ssm_conv - 1, c)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"]["pos0"]["ssm"])
    out_j, (st_j, tail_j) = jax.jit(
        lambda p, v, c: j_ssm.mamba2_decode(p, v, jcfg, NO_SHARDING, c))(
            lp_j, jnp.asarray(x), (jnp.asarray(st), jnp.asarray(tail)))
    before = t_ssd.LAUNCHES
    out_t, (st_t, tail_t) = t_ssm.mamba2_decode(
        tp["groups"][0]["pos0"]["ssm"], torch.from_numpy(x), tcfg, t_sharding.NO_SHARDING,
        (torch.from_numpy(st), torch.from_numpy(tail)))
    assert t_ssd.LAUNCHES == before  # the CPU route runs the plain version
    _close(out_t, out_j)
    _close(st_t, st_j)
    _close(tail_t, tail_j)


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("name,b,s", [("smoke", 2, 12), ("mixer", 2, 20)])
def test_forward_logits_match(name, b, s):
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(tcfg, b, s, 1)
    lj, _ = jax.jit(lambda p, t: j_lm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    lt, aux = t_lm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert float(aux) == 0.0
    assert lt.shape == (b, s, tcfg.vocab_padded)
    _close(lt, lj, LOGIT_ATOL)


def _stacked(caches):
    """The port's per-group caches stacked as the JAX package stacks them."""
    groups = caches["groups"]
    return [np.stack([g["pos0"][k].numpy() for g in groups]) for k in range(2)]


@pytest.mark.parametrize("name,b,s", [("smoke", 2, 12), ("mixer", 2, 16)])
def test_prefill_and_decode_steps_match(name, b, s):
    """``prefill`` then 4 ``decode_step``s fed the reference's greedy
    tokens: logits at every step and the caches at the end."""
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(tcfg, b, s, 2)
    lj, cj = jax.jit(lambda p, t: j_lm.prefill(p, t, jcfg))(jp, jnp.asarray(toks))
    step = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, t, c, q, jcfg))
    lt, ct = t_lm.prefill(tp, torch.from_numpy(toks).long(), tcfg)
    _close(lt, lj, LOGIT_ATOL)
    for i in range(4):
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = np.full((b,), s + i, np.int32)
        lj, cj = step(jp, jnp.asarray(tok), cj, jnp.asarray(pos))
        lt, ct = t_lm.decode_step(tp, torch.from_numpy(tok).long(), ct,
                                  torch.from_numpy(pos), tcfg)
        _close(lt, lj, LOGIT_ATOL)
    st_j, tail_j = cj["groups"]["pos0"]
    st_t, tail_t = _stacked(ct)
    _close(st_t, st_j)
    _close(tail_t, tail_j)


# -- the engine -----------------------------------------------------------------


def _port_engine(name, **kw):
    _, tcfg, _, tp = _model(name)
    return Engine(tp, tcfg, ServeConfig(**kw), device="cpu")


@pytest.mark.parametrize("name,b,s", [("smoke", 2, 20), ("smoke", 3, 4), ("mixer", 4, 16)])
def test_engine_greedy_tokens_equal_reference(name, b, s):
    """Shapes the reference's engine serves: equal greedy tokens."""
    jcfg, tcfg, jp, _ = _model(name)
    prompts = _tokens(tcfg, b, s, 3)
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=6)).generate(prompts)
    got = _port_engine(name, max_new_tokens=6).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, want)


def _reference_manual_loop(jp, jcfg, prompts, new_tokens):
    """The reference's ``Engine.generate`` without its cache growth:
    ``lm.prefill`` on the zero-padded prompt, then greedy ``decode_step`` at
    ``pos = s + i``."""
    b, s = prompts.shape
    s_pad = 1 << (s - 1).bit_length()
    toks = jnp.asarray(np.pad(prompts, ((0, 0), (0, s_pad - s))))
    logits, caches = jax.jit(lambda p, t: j_lm.prefill(p, t, jcfg))(jp, toks)
    step = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, t, c, q, jcfg))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = []
    for i in range(new_tokens):
        out.append(np.asarray(tok))
        logits, caches = step(jp, tok, caches, jnp.full((b,), s + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name,b,s", [("smoke", 2, 12), ("mixer", 4, 32)])
def test_engine_matches_reference_loop_where_its_engine_fails(name, b, s):
    """At these shapes the reference's ``Engine._grow_seq`` pads a state axis
    of the SSM cache (its size equals the padded prompt length) and the
    decode fails; the port grows caches by kind and serves them, with the
    tokens of the reference's own prefill + decode loop."""
    jcfg, tcfg, jp, _ = _model(name)
    prompts = _tokens(tcfg, b, s, 4)
    want = _reference_manual_loop(jp, jcfg, prompts, 6)
    got = _port_engine(name, max_new_tokens=6).generate(prompts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,s", [(2, 12), (3, 5), (2, 16), (4, 3), (1, 1), (2, 2)])
def test_engine_serves_any_prompt_shape(b, s):
    """Prompt shapes whose padded length coincides with a cache size of the
    smoke model (the reference's engine fails at the first four), and
    prompts shorter than the conv window."""
    _, tcfg, _, _ = _model("smoke")
    out = _port_engine("smoke", max_new_tokens=3).generate(_tokens(tcfg, b, s, 5))
    assert out.shape == (b, 3)
    assert np.all((out >= 0) & (out < tcfg.vocab))


def test_engine_eos_stopping_matches_reference():
    jcfg, tcfg, jp, _ = _model("smoke")
    prompts = _tokens(tcfg, 3, 4, 6)
    free = _port_engine("smoke", max_new_tokens=8).generate(prompts)
    eos = int(free[0, 2])
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=8, eos_id=eos)).generate(prompts)
    got = _port_engine("smoke", max_new_tokens=8, eos_id=eos).generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[0, 3:] == eos)


def test_engine_temperature_sampling_is_seeded():
    """Sampling draws from an explicit generator: the same seed gives the
    same tokens; the draws are not the reference's (other bits)."""
    _, tcfg, _, _ = _model("smoke")
    prompts = _tokens(tcfg, 2, 8, 7)
    eng = _port_engine("smoke", max_new_tokens=8, temperature=1.0)
    a, b = eng.generate(prompts, seed=1), eng.generate(prompts, seed=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, eng.generate(prompts, seed=2))
    greedy = _port_engine("smoke", max_new_tokens=8).generate(prompts)
    assert not np.array_equal(a, greedy)


# -- refusals and the CLI ------------------------------------------------------


def test_entry_points_need_cuda_without_device(monkeypatch):
    _, tcfg, _, tp = _model("smoke")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_lm.init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tp, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--arch", "mamba2-370m", "--batch", "1", "--prompt-len", "2",
                      "--new-tokens", "1"])


def test_serve_cli_prints_the_reference_line(capsys):
    assert t_serve.main(["--arch", "mamba2-370m", "--preset", "smoke", "--batch", "2",
                         "--prompt-len", "12", "--new-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"serve_done arch=mamba2-370m batch=2 new_tokens=3 .*tok_per_s=", out)

"""The port's attention families on the CPU against the JAX package:
``models.layers`` (RoPE, the gated MLP), ``models.attention`` (causal,
blocked, banded and decode attention, the int8 KV cache), ``models.lm``'s
``"attn"``, ``"attn_w"`` and ``"hybrid_attn"`` kinds and
``serve.engine.Engine`` over them, on the same weights
(``models.convert.params_from_numpy``) and the same seeded numpy inputs.

Sizes: the smoke presets of granite-3-2b, gemma-7b (GeGLU), chameleon-34b
(qk-norm), yi-34b, gemma3-12b (5 local layers of window 8 + 1 global) and
zamba2-2.7b (2 groups of 2 SSM layers + the shared attention block), and
granite-3-2b at full width (``configs.get``, cut to 1 layer and vocab 512:
d_model 2048, 32 query and 8 K/V heads of 64).

Tolerances: float32 on both sides, rtol 1e-4 and atol 1e-5 (1e-4 on
logits), as the Mamba2 tests use: the two packages take the same float32
formulas and differ in the order of their sums. Measured on the CPU, the
largest logit differences are 4.2e-7 (granite smoke), 3.9e-6 (gemma-7b,
gemma3) and 5.8e-6 (granite at full width, logits up to 4.4). bfloat16
(``cfg.dtype``, the default) on both sides: logits within atol 2e-2 of the
reference's, about five bf16 ulps of the logits' scale (measured 7.8e-3,
two ulps, on the granite smoke model's logits of size up to 0.65); the
products round to bf16 in a different order. ``quantize_kv`` is held bit
for bit. Greedy tokens are held equal in float32.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.dist.sharding import NO_SHARDING  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import ssd_decode as t_ssd  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

RTOL, ATOL, LOGIT_ATOL = 1e-4, 1e-5, 1e-4
BF16_LOGIT_ATOL = 2e-2
ARCHS = ("granite-3-2b", "gemma-7b", "chameleon-34b", "yi-34b", "gemma3-12b", "zamba2-2.7b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(name):
    if name == "granite-full":
        kw = dict(n_layers=1, vocab=512)
        return (j_configs.get("granite-3-2b").with_overrides(**kw),
                t_configs.get("granite-3-2b").with_overrides(**kw))
    if name.endswith("-bf16"):
        arch = name.removesuffix("-bf16")
        return j_configs.smoke(arch), t_configs.smoke(arch)
    return j_configs.smoke(name), t_configs.smoke(name)


_MODELS = {}


def _model(name):
    """(jax cfg, port cfg, jax params, port params), built once per name;
    float32 weights unless the name ends in -bf16 (then ``cfg.dtype``)."""
    if name not in _MODELS:
        jcfg, tcfg = _cfgs(name)
        kw = {} if name.endswith("-bf16") else {"dtype": jnp.float32}
        jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, **kw))(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _tokens(cfg, b, s, seed):
    return _rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("batched", [True, False])
def test_apply_rope_matches(theta, batched):
    """Split-halves rotation at (B, S) and (S,) positions, past 1,000."""
    rng = _rng(0)
    x = _normal(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 3000, (2, 7) if batched else (7,)).astype(np.int32)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_layers.apply_rope(_t(x), _t(pos).long(), theta)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, want)
    _close(t_layers.rope_angles(_t(pos).long(), 16, theta),
           j_layers.rope_angles(jnp.asarray(pos), 16, theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp_matches(act):
    rng = _rng(1)
    params = {"wi_gate": _normal(rng, 32, 48), "wi_up": _normal(rng, 32, 48),
              "wo": _normal(rng, 48, 32)}
    x = _normal(rng, 2, 5, 32)
    want = j_layers.mlp({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), act,
                        NO_SHARDING)
    got = t_layers.mlp({k: _t(v) for k, v in params.items()}, _t(x), act)
    _close(got, want)


# -- attention -----------------------------------------------------------------


def _qkv(b, s, h=4, kv=2, dh=16, seed=2, t=None):
    rng = _rng(seed)
    t = t or s
    return _normal(rng, b, s, h, dh), _normal(rng, b, t, kv, dh), _normal(rng, b, t, kv, dh)


@pytest.mark.parametrize("window", [0, 5])
def test_causal_attention_matches(window):
    q, k, v = _qkv(2, 13)
    pos = _positions(2, 13)
    want = j_attn.causal_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window)
    got = t_attn.causal_attention(*map(_t, (q, k, v)), _t(pos).long(), _t(pos).long(), window)
    _close(got, want)


def test_fully_masked_rows_are_uniform_not_nan():
    """NEG_INF = -2**30, not -inf: a query that sees no key averages them."""
    q, k, v = _qkv(1, 4)
    qpos = np.full((1, 4), -1, np.int32)
    kpos = _positions(1, 4)
    got = t_attn.causal_attention(*map(_t, (q, k, v)), _t(qpos).long(), _t(kpos).long())
    assert bool(torch.all(torch.isfinite(got)))
    mean_v = _t(v).mean(dim=1)  # (1, KV, dh)
    _close(got[0, 0, 0], mean_v[0, 0])
    assert t_attn.NEG_INF == j_attn.NEG_INF == -2.0**30


@pytest.mark.parametrize("s,window,q_chunk", [(64, 0, 16), (48, 0, 16), (40, 8, 0),
                                              (32, 16, 0), (20, 0, 16), (8, 8, 0)])
def test_blocked_attention_matches(s, window, q_chunk):
    """Several full chunks, several window chunks (chunk 0 sees chunk 1's
    keys, masked), and the shapes that fall back to causal_attention (S not
    a chunk multiple, S equal to the window)."""
    q, k, v = _qkv(2, s, seed=s)
    pos = _positions(2, s)
    want = j_attn.blocked_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window,
                                    q_chunk or 256)
    got = t_attn.blocked_attention(*map(_t, (q, k, v)), _t(pos).long(), _t(pos).long(),
                                   window, q_chunk or 256)
    _close(got, want)
    # and the windowed / chunked forms agree with the plain masked form
    _close(got, t_attn.causal_attention(*map(_t, (q, k, v)), _t(pos).long(),
                                        _t(pos).long(), window))


@pytest.mark.parametrize("s,window", [(32, 8), (24, 4)])
def test_banded_attention_matches(s, window):
    q, k, v = _qkv(2, s, seed=7)
    pos = _positions(2, s)
    want = j_attn.banded_attention(*map(jnp.asarray, (q, k, v, pos)), window)
    got = t_attn.banded_attention(*map(_t, (q, k, v)), _t(pos).long(), window)
    _close(got, want)
    _close(got, t_attn.causal_attention(*map(_t, (q, k, v)), _t(pos).long(), _t(pos).long(),
                                        window))


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_matches(window):
    """Per-row lengths, one of them past the window."""
    q, k, v = _qkv(3, 1, t=24, seed=9)
    pos = np.asarray([3, 17, 24], np.int32)
    want = j_attn.decode_attention(*map(jnp.asarray, (q, k, v, pos)), window)
    got = t_attn.decode_attention(*map(_t, (q, k, v)), _t(pos).long(), window)
    _close(got, want)


def test_quantize_kv_bit_for_bit():
    rng = _rng(11)
    x = _normal(rng, 2, 9, 3, 16) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero head: the 1e-6 floor
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round to even
    qj, sj = j_attn.quantize_kv(jnp.asarray(x))
    qt, st = t_attn.quantize_kv(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.float().numpy(), np.asarray(sj).astype(np.float32))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = t_attn.dequantize_kv(qt, st, dtype).float().numpy()
        want = np.asarray(j_attn.dequantize_kv(qj, sj, jdtype)).astype(np.float32)
        assert np.array_equal(got, want)


# -- the models ----------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own init gives the carried tree's leaves, shapes and
    types, at the same scales (standard deviations within 10%)."""
    _, tcfg, _, tp = _model(arch)
    mine = t_lm.init_params(tcfg, seed=3, dtype=torch.float32, device="cpu")
    ours, carried = dict(_leaves(mine)), dict(_leaves(tp))
    assert ours.keys() == carried.keys()
    for k, v in ours.items():
        assert v.shape == carried[k].shape and v.dtype == carried[k].dtype, k
        sd, sd_ref = float(v.std()), float(carried[k].std())
        assert abs(sd - sd_ref) <= 0.1 * sd_ref + 1e-12, (k, sd, sd_ref)


def test_params_from_numpy_unstacks_every_position():
    for arch, n_pos in (("gemma3-12b", 6), ("zamba2-2.7b", 3)):
        _, tcfg, jp, tp = _model(arch)
        assert sorted(tp["groups"][0]) == [f"pos{i}" for i in range(n_pos)]
        for g in range(tcfg.n_groups):
            for i, kind in enumerate(t_lm.group_layout(tcfg)):
                leaf = {"ssm": ("ssm", "w_zx"), "hybrid_attn": ("proj",)}.get(kind, ("mlp", "wo"))
                want = jp["groups"][f"pos{i}"]
                got = tp["groups"][g][f"pos{i}"]
                for key in leaf:
                    want, got = want[key], got[key]
                assert np.array_equal(got.numpy(), np.asarray(want)[g])
    _, _, jp, tp = _model("zamba2-2.7b")
    assert np.array_equal(tp["shared"]["attn"]["wq"].numpy(),
                          np.asarray(jp["shared"]["attn"]["wq"]))
    _, _, jp, tp = _model("granite-3-2b-bf16")
    assert tp["groups"][0]["pos0"]["attn"]["wq"].dtype == torch.bfloat16
    assert np.array_equal(tp["embed"]["tok"].float().numpy(),
                          np.asarray(jp["embed"]["tok"]).astype(np.float32))


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b", "zamba2-2.7b"])
@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_init_cache_matches_reference_by_kind(arch, kv_quant):
    jcfg, tcfg = (c.with_overrides(kv_quant=kv_quant) for c in _cfgs(arch))
    want = j_lm.init_cache(jcfg, 2, 24, jnp.float32)["groups"]
    got = t_lm.init_cache(tcfg, 2, 24, torch.float32, device="cpu")
    assert len(got["groups"]) == tcfg.n_groups
    for i in range(len(t_lm.group_layout(tcfg))):
        w, g = want[f"pos{i}"], got["groups"][0][f"pos{i}"]
        assert len(w) == len(g)
        for a, b in zip(w, g):
            assert tuple(b.shape) == a.shape[1:]
            assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
            assert not bool(torch.any(b != 0))


@pytest.mark.parametrize("arch,b,s", [(a, 2, 12) for a in ARCHS]
                         + [("gemma3-12b", 2, 32), ("granite-full", 2, 20)])
def test_forward_logits_match(arch, b, s):
    """gemma3 at S=32: the windowed blocked path in 4 chunks of 8."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(tcfg, b, s, 1)
    lj, _ = jax.jit(lambda p, t: j_lm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    lt = t_lm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert lt.shape == (b, s, tcfg.vocab_padded)
    _close(lt, lj, LOGIT_ATOL)


def _stacked(caches, i):
    """The port's per-group cache entry ``pos{i}`` stacked as the JAX
    package stacks it."""
    groups = caches["groups"]
    return [np.stack([g[f"pos{i}"][k].float().numpy() for g in groups])
            for k in range(len(groups[0][f"pos{i}"]))]


@pytest.mark.parametrize("arch,s", [(a, 12) for a in ARCHS]
                         + [("gemma3-12b", 16), ("granite-full", 16)])
def test_prefill_and_decode_steps_match(arch, s):
    """``prefill`` into a cache of S + 5, then 5 ``decode_step``s fed the
    reference's greedy tokens: logits at every step and every cache at the
    end (gemma3 at S=16: decode past the window of 8)."""
    jcfg, tcfg, jp, tp = _model(arch)
    b = 2
    toks = _tokens(tcfg, b, s, 2)
    lj, cj = jax.jit(lambda p, t: j_lm.prefill(p, t, jcfg, max_seq=s + 5))(jp, jnp.asarray(toks))
    step = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, t, c, q, jcfg))
    lt, ct = t_lm.prefill(tp, torch.from_numpy(toks).long(), tcfg, max_seq=s + 5)
    _close(lt, lj, LOGIT_ATOL)
    for i in range(5):
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = np.full((b,), s + i, np.int32)
        lj, cj = step(jp, jnp.asarray(tok), cj, jnp.asarray(pos))
        lt, ct = t_lm.decode_step(tp, torch.from_numpy(tok).long(), ct,
                                  torch.from_numpy(pos).long(), tcfg)
        _close(lt, lj, LOGIT_ATOL)
    for i in range(len(t_lm.group_layout(tcfg))):
        for got, want in zip(_stacked(ct, i), cj["groups"][f"pos{i}"]):
            assert got.shape == want.shape
            _close(got, want)


def test_bf16_logits_within_stated_tolerance():
    """``cfg.dtype`` (bfloat16) weights on both sides: forward, prefill and
    two decode steps."""
    jcfg, tcfg, jp, tp = _model("granite-3-2b-bf16")
    assert tcfg.dtype == "bfloat16" and tp["embed"]["tok"].dtype == torch.bfloat16
    toks = _tokens(tcfg, 2, 16, 12)

    def close(got, want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                                   rtol=0, atol=BF16_LOGIT_ATOL)

    lj, _ = jax.jit(lambda p, t: j_lm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    close(t_lm.forward(tp, torch.from_numpy(toks).long(), tcfg), lj)
    lj, cj = jax.jit(lambda p, t: j_lm.prefill(p, t, jcfg, max_seq=18))(jp, jnp.asarray(toks))
    lt, ct = t_lm.prefill(tp, torch.from_numpy(toks).long(), tcfg, max_seq=18)
    close(lt, lj)
    assert ct["groups"][0]["pos0"][0].dtype == torch.bfloat16
    for i in range(2):
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = np.full((2,), 16 + i, np.int32)
        lj, cj = j_lm.decode_step(jp, jnp.asarray(tok), cj, jnp.asarray(pos), jcfg)
        lt, ct = t_lm.decode_step(tp, torch.from_numpy(tok).long(), ct,
                                  torch.from_numpy(pos).long(), tcfg)
        close(lt, lj)


def test_int8_kv_cache_close_to_unquantized():
    """``tests/test_serve.py::test_int8_kv_cache_close_to_bf16`` on the
    port: a decode over the int8 cache within 0.05 of ``forward``'s logits
    and with its greedy token; the int8 caches equal the reference's."""
    jcfg, tcfg, jp, tp = _model("granite-3-2b")
    jq, tq = jcfg.with_overrides(kv_quant="int8"), tcfg.with_overrides(kv_quant="int8")
    b, s = 2, 16
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, s), 0, tcfg.vocab))
    tt = torch.from_numpy(tokens).long()
    full = t_lm.forward(tp, tt, tcfg)
    last, caches = t_lm.prefill(tp, tt[:, : s - 1], tq, max_seq=s)
    assert caches["groups"][0]["pos0"][0].dtype == torch.int8
    dec, caches = t_lm.decode_step(tp, tt[:, s - 1], caches, torch.full((b,), s - 1), tq)
    err = float((dec - full[:, s - 1]).abs().max())
    assert err < 0.05, err
    assert torch.equal(torch.argmax(dec, -1), torch.argmax(full[:, s - 1], -1))

    _, cj = j_lm.prefill(jp, jnp.asarray(tokens[:, : s - 1]), jq, max_seq=s)
    dj, cj = j_lm.decode_step(jp, jnp.asarray(tokens[:, s - 1]), cj,
                              jnp.full((b,), s - 1, jnp.int32), jq)
    _close(dec, dj, LOGIT_ATOL)
    for got, want in zip(_stacked(caches, 0), cj["groups"]["pos0"]):
        if want.dtype == jnp.int8:  # a value may sit at a rounding tie: +-1
            assert np.abs(got - np.asarray(want, np.float32)).max() <= 1
        else:
            np.testing.assert_allclose(got, np.asarray(want).astype(np.float32), rtol=1e-2)


def test_grow_caches_pads_attention_kv_only():
    _, tcfg, _, tp = _model("zamba2-2.7b")
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, 4)).long()
    _, short = t_lm.prefill(tp, toks, tcfg)
    _, grown = t_lm.prefill(tp, toks, tcfg, max_seq=29)
    for i, kind in enumerate(t_lm.group_layout(tcfg)):
        for a, g in zip(short["groups"][0][f"pos{i}"], grown["groups"][0][f"pos{i}"]):
            if kind == "hybrid_attn":
                assert g.shape[1] == 29 and torch.equal(g[:, :16], a)
                assert not bool(torch.any(g[:, 16:] != 0))
            else:
                assert torch.equal(g, a)  # the SSM state and conv tail as they are


# -- the engine ----------------------------------------------------------------


def _port_engine(arch, **kw):
    _, tcfg, _, tp = _model(arch)
    return Engine(tp, tcfg, ServeConfig(**kw), device="cpu")


@pytest.mark.parametrize("arch,b,s", [("granite-3-2b", 3, 16), ("granite-3-2b", 2, 11),
                                      ("gemma-7b", 2, 13), ("chameleon-34b", 3, 9),
                                      ("yi-34b", 2, 16), ("gemma3-12b", 2, 27),
                                      ("gemma3-12b", 3, 16), ("granite-full", 2, 20)])
def test_engine_greedy_tokens_equal_reference(arch, b, s):
    """Prompts padded up the bucket grid (S=11 -> 16, S=27 -> 32: gemma3's
    windowed blocked path in 4 chunks, decode past the window)."""
    jcfg, tcfg, jp, _ = _model(arch)
    prompts = _tokens(tcfg, b, s, 3)
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=6)).generate(prompts)
    got = _port_engine(arch, max_new_tokens=6).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, want)


def test_engine_without_bucketing_equals_reference():
    jcfg, tcfg, jp, _ = _model("granite-3-2b")
    prompts = _tokens(tcfg, 2, 11, 8)
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=5, bucket_prompts=False)).generate(prompts)
    got = _port_engine("granite-3-2b", max_new_tokens=5, bucket_prompts=False).generate(prompts)
    np.testing.assert_array_equal(got, want)


def _reference_manual_loop(jp, jcfg, prompts, new_tokens):
    """The reference's ``Engine.generate`` with the caches grown by kind:
    ``lm.prefill`` of the zero-padded prompt, the shared block's K/V padded
    by hand to the padded length plus the new tokens (the reference's own
    growth, in ``_grow_seq`` and in ``prefill(max_seq=)``, pads an SSM state
    axis whose size equals the padded length), then greedy ``decode_step``
    at ``s + i``."""
    b, s = prompts.shape
    s_pad = 1 << (s - 1).bit_length()
    toks = jnp.asarray(np.pad(prompts, ((0, 0), (0, s_pad - s))))
    logits, caches = jax.jit(lambda p, t: j_lm.prefill(p, t, jcfg))(jp, toks)
    for i, kind in enumerate(j_lm.group_layout(jcfg)):
        if kind == "hybrid_attn":  # (G, B, S, KV, dh)
            caches["groups"][f"pos{i}"] = tuple(
                jnp.pad(a, ((0, 0), (0, 0), (0, new_tokens), (0, 0), (0, 0)))
                for a in caches["groups"][f"pos{i}"])
    step = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, t, c, q, jcfg))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = []
    for i in range(new_tokens):
        out.append(np.asarray(tok))
        logits, caches = step(jp, tok, caches, jnp.full((b,), s + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("b,s", [(2, 12), (3, 5)])
def test_zamba2_engine_matches_reference_loop(b, s):
    """The reference's ``Engine`` fails on zamba2 (``_grow_seq`` pads an SSM
    state axis); the port grows the shared block's K/V only and serves the
    tokens of the reference's own prefill + decode loop, with one decode
    kernel call per SSM layer and step (plain version on the CPU)."""
    jcfg, tcfg, jp, _ = _model("zamba2-2.7b")
    prompts = _tokens(tcfg, b, s, 4)
    with pytest.raises(TypeError):
        JEngine(jp, jcfg, JServeConfig(max_new_tokens=6)).generate(prompts)
    want = _reference_manual_loop(jp, jcfg, prompts, 6)
    before = t_ssd.LAUNCHES
    got = _port_engine("zamba2-2.7b", max_new_tokens=6).generate(prompts)
    assert t_ssd.LAUNCHES == before  # the CPU route runs the plain version
    np.testing.assert_array_equal(got, want)


def test_engine_eos_stopping_matches_reference():
    jcfg, tcfg, jp, _ = _model("gemma-7b")
    prompts = _tokens(tcfg, 3, 7, 6)
    free = _port_engine("gemma-7b", max_new_tokens=8).generate(prompts)
    eos = int(free[0, 2])
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=8, eos_id=eos)).generate(prompts)
    got = _port_engine("gemma-7b", max_new_tokens=8, eos_id=eos).generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[0, 3:] == eos)


def test_serve_cli_defaults_to_granite(capsys):
    assert t_serve.main(["--preset", "smoke", "--batch", "2", "--prompt-len", "12",
                         "--new-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"serve_done arch=granite-3-2b batch=2 new_tokens=3 .*tok_per_s=", out)


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_moe_mla_and_encoder_decoder_still_raise(arch):
    """Only the encoder-decoder family is still missing (MLA and MoE are
    held by ``tests/test_torch_moe.py``)."""
    with pytest.raises(t_lm.NotPorted, match="queue 1 item 3"):
        t_lm.forward({}, torch.zeros((1, 1), dtype=torch.long), t_configs.smoke(arch))

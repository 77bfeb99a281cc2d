"""The port's encoder-decoder family (whisper) on the CPU against the JAX
package: ``models.lm``'s ``"enc"`` and ``"xattn"`` kinds, ``_encode``,
``forward(enc_in=)``, ``prefill(enc_in=)`` and ``decode_step`` over the
``{"self", "cross"}`` caches, ``serve.engine.Engine.generate(enc=)``,
``models.convert.params_from_numpy`` on whisper's tree and
``launch.serve`` for whisper, on the same weights and the same seeded
numpy inputs (tokens and frame embeddings).

Sizes: the smoke preset of whisper-base (2 encoder and 2 decoder layers,
d_model 64, 4/4 heads of 16, d_ff 128, GeGLU, vocab 512, enc_len 24) and
whisper-base at full width (d_model 512, 8/8 heads of 64, d_ff 2048) cut
to 1 encoder and 1 decoder layer, enc_len 48 and vocab 512.

The reference pads caches by matching sizes, not by kind: its
``prefill(max_seq=)`` (``src/repro/models/lm.py:548-560``) pads a cross
K/V (G, B, enc_len, KV, dh) whose enc_len or KV equals the prompt length,
and its ``Engine._grow_seq`` (``src/repro/serve/engine.py:91-98``) pads the
first axis after the group axis whose size equals the padded prompt
length: B, enc_len, KV or dh. Every shape compared with the reference here
keeps B, the group count, enc_len, KV and dh apart from every (padded)
prompt length; ``test_engine_at_a_padded_length_equal_to_dh`` serves the
case the reference's engine gets wrong against its own prefill and decode
loop with the caches grown by kind.

Tolerances: float32 on both sides, those of ``tests/test_torch_attention.py``
(rtol 1e-4, atol 1e-5, 1e-4 on logits; measured 4.2e-6 on the smoke
logits). bfloat16 (``cfg.dtype``) on both sides, with bfloat16 frames (the
port casts the frames to the weights' dtype; the reference would promote a
float32 input's products to float32): within ``BF16_ULPS`` = 5 bf16 ulps
of the largest reference logit, the rule of ``tests/test_torch_moe.py``
(measured 0.0625, two ulps, on the smoke logits of scale 4.6; allowed
0.156). Greedy tokens equal.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.dist.sharding import NO_SHARDING  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_names  # noqa: E402

RTOL, ATOL, LOGIT_ATOL = 1e-4, 1e-5, 1e-4
BF16_ULPS = 5
ARCH = "whisper-base"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol)


def _cfgs(name):
    if name == "full-cut":
        kw = dict(n_layers=1, n_enc_layers=1, enc_len=48, vocab=512)
        return (j_configs.get(ARCH).with_overrides(**kw),
                t_configs.get(ARCH).with_overrides(**kw))
    return j_configs.smoke(ARCH), t_configs.smoke(ARCH)


_MODELS = {}


def _model(name):
    """(jax cfg, port cfg, jax params, port params), built once per name;
    float32 weights unless the name is "bf16" (then ``cfg.dtype``)."""
    if name not in _MODELS:
        jcfg, tcfg = _cfgs(name)
        kw = {} if name == "bf16" else {"dtype": jnp.float32}
        jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, **kw))(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _frames(cfg, b, seed):
    rng = np.random.default_rng(1000 + seed)
    return rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- parameters ----------------------------------------------------------------


def test_params_from_numpy_unstacks_the_encoder_and_decoder():
    jcfg, tcfg, jp, tp = _model("smoke")
    assert len(tp["enc_groups"]) == tcfg.n_enc_layers and len(tp["groups"]) == tcfg.n_groups
    names = dict(tree_flatten_with_names(tp))
    for name, leaf in tree_flatten_with_names(jax.tree.map(np.asarray, jp)):
        head, _, rest = name.partition("/")
        if head in ("groups", "enc_groups"):
            for i in range(leaf.shape[0]):
                got = names.pop(f"{head}/{i}/{rest}")
                np.testing.assert_array_equal(got.numpy(), leaf[i])
        else:
            np.testing.assert_array_equal(names.pop(name).numpy(), leaf)
    assert not names  # every leaf of the port's tree came from the reference's
    assert set(tp["groups"][0]["pos0"]) == {"ln1", "attn", "ln_x", "xattn", "ln2", "mlp"}


def test_init_params_has_the_reference_layout():
    """The port's own init: every leaf of the reference's tree, with its
    shape and dtype (``cfg.dtype``, norms float32), and the learned
    encoder positions at the reference's 0.02 scale."""
    jcfg, tcfg = _cfgs("smoke")
    jp = jax.eval_shape(lambda k: j_lm.init_params(k, jcfg), jax.random.PRNGKey(0))
    tp = t_lm.init_params(tcfg, seed=3, device="cpu")
    got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in tree_flatten_with_names(tp)}
    want = {}
    for name, leaf in tree_flatten_with_names(jp):
        head, _, rest = name.partition("/")
        if head in ("groups", "enc_groups"):
            for i in range(leaf.shape[0]):
                want[f"{head}/{i}/{rest}"] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            want[name] = (tuple(leaf.shape), str(leaf.dtype))
    assert got == want
    assert abs(float(tp["enc_pos"].float().std()) - 0.02) < 0.002


# -- the encoder and the forward pass -------------------------------------------


@pytest.mark.parametrize("name", ["smoke", "full-cut"])
def test_encode_matches_reference(name):
    jcfg, tcfg, jp, tp = _model(name)
    enc = _frames(tcfg, 2, 0)
    want = jax.jit(lambda p, e: j_lm._encode(p, e, jcfg, NO_SHARDING))(jp, jnp.asarray(enc))
    got = t_lm._encode(tp, _t(enc), tcfg)
    assert got.shape == (2, tcfg.enc_len, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("name,b,s", [("smoke", 3, 10), ("smoke", 2, 1), ("full-cut", 2, 20)])
def test_forward_logits_match(name, b, s):
    jcfg, tcfg, jp, tp = _model(name)
    toks, enc = _tokens(tcfg, b, s, 1), _frames(tcfg, b, 1)
    lj, aux_j = jax.jit(lambda p, t, e: j_lm.forward(p, t, jcfg, enc_in=e))(
        jp, jnp.asarray(toks), jnp.asarray(enc))
    lt, aux = t_lm.forward(tp, _t(toks).long(), tcfg, enc_in=_t(enc))
    assert lt.shape == (b, s, tcfg.vocab_padded)
    _close(lt, lj, LOGIT_ATOL)
    assert float(aux) == float(aux_j) == 0.0


def test_bf16_logits_within_stated_tolerance():
    """``cfg.dtype`` weights and bfloat16 frames on both sides: forward,
    prefill and two decode steps."""
    jcfg, tcfg, jp, tp = _model("bf16")
    assert tp["enc_pos"].dtype == torch.bfloat16
    b, s = 2, 12
    toks = _tokens(tcfg, b, s, 2)
    enc = jnp.asarray(_frames(tcfg, b, 2)).astype(jnp.bfloat16)
    enc_t = torch.from_numpy(np.array(enc.astype(jnp.float32))).to(torch.bfloat16)

    def close(got, want):
        want = np.asarray(want).astype(np.float32)
        atol = BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)

    lj, _ = jax.jit(lambda p, t, e: j_lm.forward(p, t, jcfg, enc_in=e))(jp, jnp.asarray(toks), enc)
    close(t_lm.forward(tp, _t(toks).long(), tcfg, enc_in=enc_t)[0], lj)
    lj, cj = jax.jit(lambda p, t, e: j_lm.prefill(p, t, jcfg, max_seq=s + 2, enc_in=e))(
        jp, jnp.asarray(toks), enc)
    lt, ct = t_lm.prefill(tp, _t(toks).long(), tcfg, max_seq=s + 2, enc_in=enc_t)
    close(lt, lj)
    assert ct["groups"][0]["pos0"]["cross"][0].dtype == torch.bfloat16
    for i in range(2):
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = np.full((b,), s + i, np.int32)
        lj, cj = j_lm.decode_step(jp, jnp.asarray(tok), cj, jnp.asarray(pos), jcfg)
        lt, ct = t_lm.decode_step(tp, _t(tok).long(), ct, _t(pos).long(), tcfg)
        close(lt, lj)


def test_encoder_decoder_needs_its_input():
    _, tcfg, _, tp = _model("smoke")
    with pytest.raises(ValueError, match="enc_in"):
        t_lm.forward(tp, torch.zeros((1, 3), dtype=torch.long), tcfg)
    with pytest.raises(ValueError, match="enc_in"):
        Engine(tp, tcfg, device="cpu").generate(np.zeros((1, 3), np.int32))


# -- caches, prefill and decode --------------------------------------------------


def _stacked(caches, part):
    """The port's per-group ``xattn`` cache part stacked as the JAX package
    stacks it."""
    groups = caches["groups"]
    return [np.stack([g["pos0"][part][k].float().numpy() for g in groups]) for k in range(2)]


@pytest.mark.parametrize("name,b,s", [("smoke", 3, 12), ("smoke", 3, 5), ("full-cut", 3, 20)])
def test_prefill_and_decode_steps_match(name, b, s):
    """``prefill`` into a cache of S + 5, then 5 ``decode_step``s fed the
    reference's greedy tokens: logits at every step, the self and cross
    K/V at the end."""
    jcfg, tcfg, jp, tp = _model(name)
    toks, enc = _tokens(tcfg, b, s, 2), _frames(tcfg, b, 2)
    lj, cj = jax.jit(lambda p, t, e: j_lm.prefill(p, t, jcfg, max_seq=s + 5, enc_in=e))(
        jp, jnp.asarray(toks), jnp.asarray(enc))
    step = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, t, c, q, jcfg))
    lt, ct = t_lm.prefill(tp, _t(toks).long(), tcfg, max_seq=s + 5, enc_in=_t(enc))
    _close(lt, lj, LOGIT_ATOL)
    for i in range(5):
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = np.full((b,), s + i, np.int32)
        lj, cj = step(jp, jnp.asarray(tok), cj, jnp.asarray(pos))
        lt, ct = t_lm.decode_step(tp, _t(tok).long(), ct, _t(pos).long(), tcfg)
        _close(lt, lj, LOGIT_ATOL)
    for part in ("self", "cross"):
        for got, want in zip(_stacked(ct, part), cj["groups"]["pos0"][part]):
            assert got.shape == want.shape
            _close(got, want)


def test_prefill_then_decode_equals_forward():
    """The port against itself: a prefill of the first S tokens and decode
    steps of the rest give ``forward``'s logits at those positions."""
    _, tcfg, _, tp = _model("smoke")
    b, s, extra = 2, 7, 4
    toks, enc = _t(_tokens(tcfg, b, s + extra, 3)).long(), _t(_frames(tcfg, b, 3))
    full, _ = t_lm.forward(tp, toks, tcfg, enc_in=enc)
    last, caches = t_lm.prefill(tp, toks[:, :s], tcfg, max_seq=s + extra, enc_in=enc)
    _close(last, full[:, s - 1], LOGIT_ATOL)
    for i in range(extra):
        last, caches = t_lm.decode_step(tp, toks[:, s + i], caches,
                                        torch.full((b,), s + i), tcfg)
        _close(last, full[:, s + i], LOGIT_ATOL)


def test_grow_caches_grows_self_kv_only():
    _, tcfg, _, tp = _model("smoke")
    toks, enc = _t(_tokens(tcfg, 3, 16, 4)).long(), _t(_frames(tcfg, 3, 4))
    _, short = t_lm.prefill(tp, toks, tcfg, enc_in=enc)
    _, grown = t_lm.prefill(tp, toks, tcfg, max_seq=29, enc_in=enc)
    for g_short, g_grown in zip(short["groups"], grown["groups"]):
        for a, g in zip(g_short["pos0"]["self"], g_grown["pos0"]["self"]):
            assert g.shape[1] == 29 and torch.equal(g[:, :16], a)
            assert not bool(torch.any(g[:, 16:] != 0))
        for a, g in zip(g_short["pos0"]["cross"], g_grown["pos0"]["cross"]):
            assert g.shape == (3, tcfg.enc_len, tcfg.n_kv_heads, tcfg.head_dim)
            assert torch.equal(g, a)
    zero = t_lm.init_cache(tcfg, 3, 29, device="cpu")["groups"][0]["pos0"]
    assert [tuple(t.shape) for t in zero["self"] + zero["cross"]] == [
        (3, 29, 4, 16), (3, 29, 4, 16), (3, 24, 4, 16), (3, 24, 4, 16)]


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("name,b,s", [("smoke", 3, 5), ("smoke", 3, 30), ("smoke", 2, 7),
                                      ("full-cut", 3, 20)])
def test_engine_greedy_tokens_equal_reference(name, b, s):
    """Prompts padded up the bucket grid (5, 7 -> 8; 20, 30 -> 32): the
    cross K/V's B, enc_len, KV and dh all differ from the padded length."""
    jcfg, tcfg, jp, tp = _model(name)
    prompts, enc = _tokens(tcfg, b, s, 5), _frames(tcfg, b, 5)
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=6)).generate(prompts, enc=jnp.asarray(enc))
    got = Engine(tp, tcfg, ServeConfig(max_new_tokens=6), device="cpu").generate(prompts, enc=enc)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, want)


def test_engine_at_a_padded_length_equal_to_dh():
    """A prompt of 11 pads to 16, the smoke config's head dim: the
    reference's ``_grow_seq`` pads each cross K/V's dh axis there. The
    port grows by kind and serves the tokens of the reference's own
    prefill and decode loop with only the self K/V grown."""
    jcfg, tcfg, jp, tp = _model("smoke")
    b, s, new = 3, 11, 6
    prompts, enc = _tokens(tcfg, b, s, 6), _frames(tcfg, b, 6)
    toks = jnp.asarray(np.pad(prompts, ((0, 0), (0, 16 - s))))
    logits, caches = jax.jit(lambda p, t, e: j_lm.prefill(p, t, jcfg, enc_in=e))(
        jp, toks, jnp.asarray(enc))
    assert caches["groups"]["pos0"]["cross"][0].shape[-1] == 16
    caches["groups"]["pos0"]["self"] = tuple(
        jnp.pad(a, ((0, 0), (0, 0), (0, new), (0, 0), (0, 0)))
        for a in caches["groups"]["pos0"]["self"])
    step = jax.jit(lambda p, t, c, q: j_lm.decode_step(p, t, c, q, jcfg))
    tok, want = jnp.argmax(logits, axis=-1).astype(jnp.int32), []
    for i in range(new):
        want.append(np.asarray(tok))
        logits, caches = step(jp, tok, caches, jnp.full((b,), s + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    got = Engine(tp, tcfg, ServeConfig(max_new_tokens=new), device="cpu").generate(prompts, enc=enc)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


def test_engine_takes_frames_as_a_tensor_and_repeats():
    _, tcfg, _, tp = _model("smoke")
    prompts, enc = _tokens(tcfg, 2, 6, 7), _frames(tcfg, 2, 7)
    eng = Engine(tp, tcfg, ServeConfig(max_new_tokens=4), device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, enc=enc),
                                  eng.generate(prompts, enc=torch.from_numpy(enc)))


def test_serve_cli_serves_whisper(capsys):
    assert t_serve.main(["--arch", ARCH, "--preset", "smoke", "--batch", "2", "--prompt-len", "6",
                         "--new-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"serve_done arch=whisper-base batch=2 new_tokens=3 .*tok_per_s=", out)

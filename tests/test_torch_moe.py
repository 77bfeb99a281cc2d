"""The port's MoE FFN and MLA on the CPU against the JAX package:
``models.moe`` (routing, capacity drops, dispatch, the ordered combine,
shared experts, the aux loss), ``models.attention``'s ``mla_block``
(prefill in the materialized form, decode in the absorbed form),
``models.lm``'s ``"mla"``, ``"mla_moe"`` and ``"attn_moe"`` kinds with
deepseek's dense prologue, and ``serve.engine.Engine`` over them, on the
same weights (``models.convert.params_from_numpy``) and the same seeded
numpy inputs.

Sizes: the smoke presets of deepseek-v2-lite-16b (1 dense MLA prologue
layer + 2 MLA+MoE groups, 8 experts top-2, 2 shared, kv_lora 32, rope 16,
nope 32) and llama4-scout-17b-a16e (2 GQA+MoE groups, 4 experts top-1, 1
shared); and deepseek-v2-lite-16b at full attention width (d_model 2048,
16 heads, kv_lora 512, rope 64, nope 128, v head 128, top-6, d_ff_expert
1408, 2 shared experts) cut to 1 prologue layer and 1 MoE layer, with 8
experts in place of 64, a prologue d_ff of 1408 in place of 10944 and a
vocab of 512 in place of 102400 (~125M float32 weights).

Capacity drops need T·k > 256: the smoke deepseek (E=8, k=2) at T=160
tokens has capacity 50, and the tests assert that the reference itself
dropped there (its output changes when the capacity factor is lifted).

The reference pads caches by matching sizes, not by kind: its
``prefill(max_seq=)`` (``src/repro/models/lm.py:548-560``) and its
``Engine._grow_seq`` (``src/repro/serve/engine.py:91``) pad the first axis
whose size equals the prompt's, which for a stacked MLA cache (G, B, S, r)
is the batch axis when B == S. Every shape here keeps B, the number of
groups and the widths apart from the (padded) prompt length.

Tolerances. float32 on both sides, those of ``tests/test_torch_attention.py``:
rtol 1e-4 and atol 1e-5 (1e-4 on logits); greedy tokens equal; expert ids
equal exactly, ties included. bfloat16 (``cfg.dtype``) on both sides: within
five bf16 ulps of the largest reference value, the rule behind that file's
atol 2e-2 on logits of scale 0.65. These models' untied heads give logits
of scale ~4.5, where five ulps are 0.156 (measured: 0.044 on llama4 smoke).
A bf16 layer input may differ by an ulp between the packages and flip an
expert at a routing near-tie (deepseek smoke, token 29 at layer 0: the
reference's 2nd and 3rd probabilities 0.15281 and 0.15184, each shifted by
up to 7.4e-4). So the bf16 test holds the logits of the sequences whose
tokens took the same experts at every layer in both packages, and requires
each flip to lie where the reference's k-th and (k+1)-th probabilities are
within ``BF16_ROUTE_GAP``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.dist.sharding import NO_SHARDING  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

RTOL, ATOL, LOGIT_ATOL = 1e-4, 1e-5, 1e-4
BF16_ULPS, BF16_ROUTE_GAP = 5, 4e-3
DEEPSEEK, LLAMA4 = "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"
ARCHS = (DEEPSEEK, LLAMA4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol)


def _bf16_close(got, want):
    """Within ``BF16_ULPS`` bf16 ulps of the largest |want|."""
    want = np.asarray(want).astype(np.float32)
    atol = BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tmap(tree, fn):
    if isinstance(tree, dict):
        return {k: _tmap(v, fn) for k, v in tree.items()}
    return fn(tree)


def _both(tree):
    """A numpy tree as (jnp tree, torch tree)."""
    return _tmap(tree, jnp.asarray), _tmap(tree, lambda a: torch.from_numpy(np.array(a)))


# -- the MoE FFN -----------------------------------------------------------------


def _moe_cfgs(**kw):
    return (j_configs.smoke(DEEPSEEK).with_overrides(**kw),
            t_configs.smoke(DEEPSEEK).with_overrides(**kw))


def _moe_weights(cfg, seed, shared=True):
    """Seeded numpy MoE weights at the reference's scales."""
    rng = _rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": _normal(rng, d, e, scale=d ** -0.5),
         "wi_gate": _normal(rng, e, d, f, scale=d ** -0.5),
         "wi_up": _normal(rng, e, d, f, scale=d ** -0.5),
         "wo": _normal(rng, e, f, d, scale=f ** -0.5)}
    if shared:
        fs = cfg.d_ff_shared * cfg.n_shared_experts
        p["shared"] = {"wi_gate": _normal(rng, d, fs, scale=d ** -0.5),
                       "wi_up": _normal(rng, d, fs, scale=d ** -0.5),
                       "wo": _normal(rng, fs, d, scale=fs ** -0.5)}
    return p


def _tokens_in(t, d, seed):
    """(T, D) layer inputs with a common offset, so that the router favours
    some experts over others and a capacity of 50 overflows at T=160."""
    return _normal(_rng(seed), t, d) + 0.5


def _experts(p, lo, n):
    """The weights of experts [lo, lo + n), the router and shared kept."""
    return {k: (v[lo:lo + n] if k in ("wi_gate", "wi_up", "wo") else v) for k, v in p.items()}


def _j_local(p, x, cfg, e_lo, e_loc):
    jp, _ = _both(p)
    out, (frac, pbar) = j_moe._moe_local(jp, jnp.asarray(x), cfg, e_lo, e_loc, 1)
    return np.asarray(out), np.asarray(frac), np.asarray(pbar)


def _t_local(p, x, cfg, e_lo, e_loc):
    _, tp = _both(p)
    out, (frac, pbar) = t_moe._moe_local(tp, torch.from_numpy(x), cfg, e_lo, e_loc, 1)
    return out.numpy(), frac.numpy(), pbar.numpy()


@pytest.mark.parametrize("t", [20, 160])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
@pytest.mark.parametrize("shared", [True, False])
def test_moe_local_matches(t, act, shared):
    """All 8 experts on one device: dropless at T=20 (T·k=40 <= 256), with
    capacity drops at T=160 (T·k=320, capacity 50)."""
    jcfg, tcfg = _moe_cfgs(act=act, n_shared_experts=2 if shared else 0)
    p = _moe_weights(tcfg, 1, shared)
    x = _tokens_in(t, tcfg.d_model, 2)
    want, got = _j_local(p, x, jcfg, 0, 8), _t_local(p, x, tcfg, 0, 8)
    for g, w in zip(got, want):
        _close(g, w)
    assert t_moe.capacity(t, tcfg) == (40 if t == 20 else 50)
    if t == 160:  # the reference itself dropped: lifting the capacity changes its output
        lifted, _ = _moe_cfgs(act=act, n_shared_experts=2 if shared else 0, capacity_factor=100.0)
        assert np.abs(_j_local(p, x, lifted, 0, 8)[0] - want[0]).max() > 1e-3


@pytest.mark.parametrize("t", [20, 160])
@pytest.mark.parametrize("e_lo,e_loc", [(2, 4), (6, 2), (4, 4)])
def test_moe_local_partial_experts_match(t, e_lo, e_loc):
    """``e_lo > 0`` and ``e_loc < E``: the partial output of a shard of the
    experts, which the sharded branch of ``moe_ffn`` sums over the model
    ranks (``tests/test_torch_tp.py``)."""
    jcfg, tcfg = _moe_cfgs(n_shared_experts=0)
    p = _moe_weights(tcfg, 3, shared=False)
    x = _tokens_in(t, tcfg.d_model, 4)
    part = _experts(p, e_lo, e_loc)
    for g, w in zip(_t_local(part, x, tcfg, e_lo, e_loc), _j_local(part, x, jcfg, e_lo, e_loc)):
        _close(g, w)


@pytest.mark.parametrize("t", [20, 160])
def test_moe_partial_outputs_sum_to_the_whole(t):
    _, tcfg = _moe_cfgs(n_shared_experts=0)
    p = _moe_weights(tcfg, 5, shared=False)
    x = _tokens_in(t, tcfg.d_model, 6)
    whole = _t_local(p, x, tcfg, 0, 8)[0]
    parts = sum(_t_local(_experts(p, lo, 2), x, tcfg, lo, 2)[0] for lo in range(0, 8, 2))
    _close(parts, whole)


@pytest.mark.parametrize("b,s", [(2, 10), (2, 80), (1, 7)])
@pytest.mark.parametrize("act,shared", [("swiglu", True), ("geglu", False)])
def test_moe_ffn_out_and_aux_match(b, s, act, shared):
    jcfg, tcfg = _moe_cfgs(act=act, n_shared_experts=2 if shared else 0)
    p = _moe_weights(tcfg, 7, shared)
    x = _normal(_rng(8), b, s, tcfg.d_model)
    jp, tp = _both(p)
    want, want_aux = j_moe.moe_ffn(jp, jnp.asarray(x), jcfg, NO_SHARDING)
    got, aux = t_moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert got.shape == (b, s, tcfg.d_model) and aux.dtype == torch.float32 and aux.ndim == 0
    _close(got, want)
    _close(aux, want_aux)


def test_moe_ffn_bf16_within_tolerance():
    jcfg, tcfg = _moe_cfgs()
    p = _moe_weights(tcfg, 9)
    x = _normal(_rng(10), 2, 12, tcfg.d_model)
    cast = _tmap(p, lambda a: a if a.shape[-1] == tcfg.n_experts and a.ndim == 2
                 else a.astype(jnp.bfloat16))
    jp = _tmap(cast, jnp.asarray)
    tp = _tmap(cast, lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float32 if a.dtype == np.float32 else torch.bfloat16))
    assert tp["router"].dtype == torch.float32 and tp["wo"].dtype == torch.bfloat16
    want, _ = j_moe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg, NO_SHARDING)
    got, _ = t_moe.moe_ffn(tp, torch.from_numpy(x).bfloat16(), tcfg)
    _bf16_close(got, want)


def _j_top_k(router, x, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    gates, eids = jax.lax.top_k(probs, k)
    return np.asarray(probs), np.asarray(gates), np.asarray(eids)


@pytest.mark.parametrize("case", ["integer_logits", "zero_router"])
def test_routing_ties_go_to_the_lower_index(case):
    """Router probabilities that tie exactly: integer logits (a duplicated
    router column, and equal sums by chance), and a zero router (every
    probability 1/E). ``route`` picks the reference's experts, the lower
    index first, and ``_moe_local`` its output."""
    jcfg, tcfg = _moe_cfgs()
    rng = _rng(11)
    x = rng.integers(-2, 3, (32, tcfg.d_model)).astype(np.float32)
    router = rng.integers(-2, 3, (tcfg.d_model, tcfg.n_experts)).astype(np.float32)
    router[:, 5] = router[:, 2]
    if case == "zero_router":
        router[:] = 0
    probs, _, want_ids = _j_top_k(router, x, tcfg.top_k)
    tprobs, gates, eids = t_moe.route(torch.from_numpy(router), torch.from_numpy(x), tcfg.top_k)
    _close(tprobs, probs)
    for pr in (probs, tprobs.numpy()):  # exact ties at the k-th choice, in both packages
        srt = -np.sort(-pr, axis=-1)
        assert np.sum(srt[:, tcfg.top_k - 1] == srt[:, tcfg.top_k]) >= 1
    np.testing.assert_array_equal(eids.numpy(), want_ids)
    if case == "zero_router":
        assert np.all(eids.numpy() == np.arange(tcfg.top_k)) and np.all(gates.numpy() == 0.5)
    p = _moe_weights(tcfg, 12)
    p["router"] = router
    for g, w in zip(_t_local(p, x, tcfg, 0, 8), _j_local(p, x, jcfg, 0, 8)):
        _close(g, w)


def test_capacity_and_arrival_order():
    """Dropless up to T·k = 256; past it ceil(T·k / E · factor). Arrival
    positions count earlier assignments to the same expert, token-major."""
    _, tcfg = _moe_cfgs()
    assert [t_moe.capacity(t, tcfg) for t in (1, 128, 129, 160)] == [2, 256, 41, 50]
    pos = t_moe.arrival(torch.tensor([3, 1, 3, 3, 0, 1]), 4)
    assert pos.tolist() == [0, 0, 1, 2, 0, 1]


# -- MLA --------------------------------------------------------------------------


def _mla_params(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jp, _ = j_attn.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    jp = dict(jp, kv_norm=jnp.asarray(_normal(_rng(seed), tcfg.kv_lora_rank, scale=0.1)))
    return jcfg, tcfg, jp, _tmap(jax.tree.map(np.asarray, jp),
                                 lambda a: torch.from_numpy(np.array(a)))


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()


@pytest.mark.parametrize("name,b,s", [("smoke", 2, 12), ("smoke", 3, 40), ("full", 2, 20)])
def test_mla_prefill_matches(name, b, s):
    """The materialized form: out and the cache (c_kv after kv_norm, k_rope
    after RoPE), against the reference's prefill branch."""
    jcfg, tcfg, jp, tp = _mla_params(name)
    x = _normal(_rng(13), b, s, tcfg.d_model)
    want, (wc, wr) = j_attn.mla_block(jp, jnp.asarray(x), jcfg, jnp.asarray(_pos(b, s)),
                                      NO_SHARDING)
    got, (gc, gr) = t_attn.mla_block(tp, torch.from_numpy(x), tcfg,
                                     torch.from_numpy(_pos(b, s)).long())
    assert got.shape == (b, s, tcfg.d_model)
    assert gc.shape == (b, s, tcfg.kv_lora_rank) and gr.shape == (b, s, tcfg.rope_head_dim)
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        _close(g, w)
    _, none = t_attn.mla_block(tp, torch.from_numpy(x), tcfg,
                               torch.from_numpy(_pos(b, s)).long(), want_cache=False)
    assert none is None


@pytest.mark.parametrize("name", ["smoke", "full"])
def test_mla_absorbed_decode_matches(name):
    """Four decode steps in the absorbed form after a prefill of 9: each
    step's out against the reference's decode branch (the same cache
    entries written), and against the materialized form of the whole
    sequence at that position; the port writes its cache in place."""
    jcfg, tcfg, jp, tp = _mla_params(name)
    b, s, steps = 2, 9, 4
    rng = _rng(14)
    x = _normal(rng, b, s + steps, tcfg.d_model)
    pos = _pos(b, s + steps)
    _, (jc, jr) = j_attn.mla_block(jp, jnp.asarray(x[:, :s]), jcfg, jnp.asarray(pos[:, :s]),
                                   NO_SHARDING)
    pad = ((0, 0), (0, steps), (0, 0))
    jcache = (jnp.pad(jc, pad), jnp.pad(jr, pad))
    _, (tc, tr) = t_attn.mla_block(tp, torch.from_numpy(x[:, :s]), tcfg,
                                   torch.from_numpy(pos[:, :s]).long())
    tcache = tuple(torch.nn.functional.pad(t, (0, 0, 0, steps)) for t in (tc, tr))
    whole, _ = t_attn.mla_block(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos).long())
    for i in range(steps):
        at = np.full((b,), s + i, np.int32)
        xi = x[:, s + i:s + i + 1]
        want, jcache = j_attn.mla_block(jp, jnp.asarray(xi), jcfg, jnp.asarray(at[:, None]),
                                        NO_SHARDING, kv_cache=jcache, cache_pos=jnp.asarray(at))
        got, new = t_attn.mla_block(tp, torch.from_numpy(xi), tcfg,
                                    torch.from_numpy(at[:, None]).long(), kv_cache=tcache,
                                    cache_pos=torch.from_numpy(at).long())
        assert new[0] is tcache[0] and new[1] is tcache[1]  # written in place
        _close(got, want)
        _close(got[:, 0], whole[:, s + i])
    for g, w in zip(tcache, jcache):
        _close(g, w)


# -- the LM entry points ----------------------------------------------------------------


def _cfgs(name):
    if name in ("full", "deepseek-full"):
        kw = dict(n_layers=2, n_experts=8, d_ff=1408, vocab=512)
        return (j_configs.get(DEEPSEEK).with_overrides(**kw),
                t_configs.get(DEEPSEEK).with_overrides(**kw))
    if name == "smoke":
        name = DEEPSEEK
    arch = name.removesuffix("-bf16")
    return j_configs.smoke(arch), t_configs.smoke(arch)


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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own init gives the carried tree's leaves (the prologue,
    the MLA and MoE leaves), shapes and types, at the same scales
    (standard deviations within 10%, or four standard errors of the
    estimate for a small leaf such as llama4 smoke's 64 x 4 router)."""
    _, tcfg, _, tp = _model(arch)
    mine = t_lm.init_params(tcfg, seed=3, dtype=torch.float32, device="cpu")
    ours, carried = dict(_leaves(mine)), dict(_leaves(tp))
    assert ours.keys() == carried.keys()
    assert ("/prologue0/attn/w_uk" in ours) == (arch == DEEPSEEK)
    assert "/groups/0/pos0/moe/router" in ours and "/groups/1/pos0/moe/shared/wo" in ours
    for k, v in ours.items():
        assert v.shape == carried[k].shape and v.dtype == carried[k].dtype, k
        sd, sd_ref = float(v.std()), float(carried[k].std())
        rel = max(0.1, 4 / (2 * v.numel()) ** 0.5)
        assert abs(sd - sd_ref) <= rel * sd_ref + 1e-12, (k, sd, sd_ref)


def test_params_from_numpy_carries_the_prologue_and_the_experts():
    jcfg, tcfg, jp, tp = _model(DEEPSEEK)
    assert t_lm.prologue_layout(tcfg) == ("mla",) and t_lm.group_layout(tcfg) == ("mla_moe",)
    for k in ("wq", "w_dkv", "w_uk", "w_uv", "wo", "kv_norm"):
        assert np.array_equal(tp["prologue0"]["attn"][k].numpy(), np.asarray(jp["prologue0"]["attn"][k]))
    assert np.array_equal(tp["prologue0"]["mlp"]["wi_gate"].numpy(),
                          np.asarray(jp["prologue0"]["mlp"]["wi_gate"]))
    assert len(tp["groups"]) == tcfg.n_groups == 2
    for g in range(tcfg.n_groups):
        moe = tp["groups"][g]["pos0"]["moe"]
        assert moe["wi_gate"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert)
        for key in ("router", "wi_gate", "wi_up", "wo"):
            assert np.array_equal(moe[key].numpy(), np.asarray(jp["groups"]["pos0"]["moe"][key])[g])
        assert np.array_equal(moe["shared"]["wo"].numpy(),
                              np.asarray(jp["groups"]["pos0"]["moe"]["shared"]["wo"])[g])
    _, _, jp16, tp16 = _model(DEEPSEEK + "-bf16")
    moe16 = tp16["groups"][1]["pos0"]["moe"]
    assert moe16["router"].dtype == torch.float32 and moe16["wo"].dtype == torch.bfloat16
    assert np.array_equal(moe16["wo"].float().numpy(),
                          np.asarray(jp16["groups"]["pos0"]["moe"]["wo"])[1].astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_init_cache_matches_reference_by_kind(arch, kv_quant):
    """An MLA cache is (c_kv, k_rope) whatever ``kv_quant`` says; a GQA
    cache (llama4) follows it; the prologue has its own entry."""
    jcfg, tcfg = (c.with_overrides(kv_quant=kv_quant) for c in _cfgs(arch))
    want = j_lm.init_cache(jcfg, 2, 24, jnp.float32)
    got = t_lm.init_cache(tcfg, 2, 24, torch.float32, device="cpu")
    assert sorted(got) == sorted(want)
    assert len(got["groups"]) == tcfg.n_groups
    pairs = [(want["groups"]["pos0"], got["groups"][0]["pos0"], True)]
    pairs += [(want[k], got[k], False) for k in want if k.startswith("prologue")]
    for w, g, stacked in pairs:
        assert len(w) == len(g)
        for a, b in zip(w, g):
            assert tuple(b.shape) == (a.shape[1:] if stacked else a.shape)
            assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
            assert not bool(torch.any(b != 0))


@pytest.mark.parametrize("arch,b,s", [(DEEPSEEK, 2, 12), (LLAMA4, 2, 12), (DEEPSEEK, 2, 80),
                                      (DEEPSEEK, 1, 1), ("deepseek-full", 2, 20)])
def test_forward_logits_match(arch, b, s):
    """deepseek at 2 x 80 drops assignments in its MoE layers (T·k = 320);
    a one-token sequence takes the materialized form."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(tcfg, b, s, 1)
    lj, aux_j = jax.jit(lambda p, t: j_lm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    lt, aux = t_lm.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert lt.shape == (b, s, tcfg.vocab_padded)
    _close(lt, lj, LOGIT_ATOL)
    _close(aux, aux_j)


@pytest.mark.parametrize("arch,b,s", [(DEEPSEEK, 2, 12), (LLAMA4, 2, 12), (DEEPSEEK, 2, 80)])
def test_backbone_aux_matches_reference(arch, b, s):
    """The sum of the MoE layers' load-balancing losses, beside the
    caches, as the reference's ``forward`` returns it."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(tcfg, b, s, 5)
    _, want = jax.jit(lambda p, t: j_lm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    x = tp["embed"]["tok"][torch.from_numpy(toks).long()]
    pos = torch.arange(s)[None, :].expand(b, s)
    _, caches, aux = t_lm._backbone(tp, x, tcfg, pos)
    assert caches is None and aux.dtype == torch.float32 and float(aux) > 0
    _close(aux, want)


def _stacked(caches, i):
    groups = caches["groups"]
    return [np.stack([g[f"pos{i}"][k].float().numpy() for g in groups])
            for k in range(len(groups[0][f"pos{i}"]))]


@pytest.mark.parametrize("arch,s", [(DEEPSEEK, 12), (LLAMA4, 12), (DEEPSEEK, 5),
                                    ("deepseek-full", 16)])
def test_prefill_and_decode_steps_match(arch, s):
    """``prefill`` into a cache of S + 5, then 5 ``decode_step``s fed the
    reference's greedy tokens: logits at every step and every cache, the
    prologue's too, at the end."""
    jcfg, tcfg, jp, tp = _model(arch)
    b = 3
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
    for got, want in zip(_stacked(ct, 0), cj["groups"]["pos0"]):
        assert got.shape == want.shape and got.shape[2] == s + 5
        _close(got, want)
    for i in range(len(t_lm.prologue_layout(tcfg))):
        for got, want in zip(ct[f"prologue{i}"], cj[f"prologue{i}"]):
            assert got.shape == want.shape == (b, s + 5, got.shape[-1])
            _close(got, want)


def test_decode_after_forward_matches_forward_logits():
    """The absorbed decode at position S against ``forward``'s materialized
    logits at S, on one model (deepseek smoke)."""
    _, tcfg, _, tp = _model(DEEPSEEK)
    b, s = 2, 14
    toks = torch.from_numpy(_tokens(tcfg, b, s + 1, 9)).long()
    full, _ = t_lm.forward(tp, toks, tcfg)
    _, caches = t_lm.prefill(tp, toks[:, :s], tcfg, max_seq=s + 1)
    dec, _ = t_lm.decode_step(tp, toks[:, s], caches, torch.full((b,), s), tcfg)
    _close(dec, full[:, s], LOGIT_ATOL)


def _spy(monkeypatch, module, calls):
    """Record (router, layer input) of every ``moe_ffn`` call of ``module``."""
    orig = module.moe_ffn

    def spy(p, x, *rest):
        calls.append((p["router"], x))
        return orig(p, x, *rest)

    monkeypatch.setattr(module, "moe_ffn", spy)


def _flipped_rows(j_calls, t_calls, k):
    """The sequences some of whose tokens took other experts in the port
    than in the reference, each package on its own layer inputs; every such
    flip must lie at a near-tie of the reference's probabilities."""
    assert len(j_calls) == len(t_calls) > 0
    rows = set()
    for (jr, jx), (tr, tx) in zip(j_calls, t_calls):
        s, d = tx.shape[1], tx.shape[2]
        probs, _, je = _j_top_k(np.asarray(jr), np.asarray(jx).astype(np.float32).reshape(-1, d), k)
        _, _, te = t_moe.route(tr, tx.reshape(-1, d), k)
        for tok in np.flatnonzero((np.sort(je, -1) != np.sort(te.numpy(), -1)).any(-1)):
            srt = -np.sort(-probs[tok])
            assert srt[k - 1] - srt[k] <= BF16_ROUTE_GAP, (tok, srt[:k + 1])
            rows.add(int(tok) // s)
    j_calls.clear()
    t_calls.clear()
    return rows


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_stated_tolerance(arch, monkeypatch):
    """``cfg.dtype`` (bfloat16) weights on both sides, the routers in
    float32: forward, prefill and two decode steps, the sequences whose
    routing agreed so far held to five bf16 ulps (the reference runs
    unrolled, ``scan_layers=False``, so that its layer inputs can be
    recorded)."""
    jcfg, tcfg, jp, tp = _model(arch + "-bf16")
    jcfg = jcfg.with_overrides(scan_layers=False)
    assert tcfg.dtype == "bfloat16" and tp["groups"][0]["pos0"]["moe"]["router"].dtype == torch.float32
    b, s, k = 2, 16, tcfg.top_k
    toks = _tokens(tcfg, b, s, 12)
    j_calls, t_calls = [], []
    _spy(monkeypatch, j_moe, j_calls)
    _spy(monkeypatch, t_moe, t_calls)
    flipped = set()

    def close(got, want):
        flipped.update(_flipped_rows(j_calls, t_calls, k))
        held = [r for r in range(b) if r not in flipped]
        assert held, "every sequence took a routing near-tie"
        _bf16_close(got[held], np.asarray(want)[held])

    lj, _ = j_lm.forward(jp, jnp.asarray(toks), jcfg)
    close(t_lm.forward(tp, torch.from_numpy(toks).long(), tcfg)[0], lj)
    flipped.clear()
    lj, cj = j_lm.prefill(jp, jnp.asarray(toks), jcfg, max_seq=s + 2)
    lt, ct = t_lm.prefill(tp, torch.from_numpy(toks).long(), tcfg, max_seq=s + 2)
    close(lt, lj)
    assert ct["groups"][0]["pos0"][0].dtype == torch.bfloat16
    for i in range(2):
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = np.full((b,), s + i, np.int32)
        lj, cj = j_lm.decode_step(jp, jnp.asarray(tok), cj, jnp.asarray(pos), jcfg)
        lt, ct = t_lm.decode_step(tp, torch.from_numpy(tok).long(), ct,
                                  torch.from_numpy(pos).long(), tcfg)
        close(lt, lj)


def test_grow_caches_pads_the_mla_and_prologue_caches():
    _, tcfg, _, tp = _model(DEEPSEEK)
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, 4)).long()
    _, short = t_lm.prefill(tp, toks, tcfg)
    _, grown = t_lm.prefill(tp, toks, tcfg, max_seq=29)
    pairs = list(zip(short["prologue0"], grown["prologue0"]))
    pairs += [(a, g) for c, d in zip(short["groups"], grown["groups"])
              for a, g in zip(c["pos0"], d["pos0"])]
    assert len(pairs) == 6
    for a, g in pairs:
        assert g.shape == (2, 29, a.shape[-1]) and torch.equal(g[:, :16], a)
        assert not bool(torch.any(g[:, 16:] != 0))


# -- the engine and the command line ---------------------------------------------------------


@pytest.mark.parametrize("arch,b,s", [(DEEPSEEK, 3, 16), (DEEPSEEK, 2, 11), (DEEPSEEK, 2, 80),
                                      (LLAMA4, 3, 16), (LLAMA4, 2, 27),
                                      ("deepseek-full", 2, 20)])
def test_engine_greedy_tokens_equal_reference(arch, b, s):
    """Prompts padded up the bucket grid (11 -> 16, 27 -> 32, 20 -> 32,
    80 -> 128: 256 tokens at prefill, with capacity drops)."""
    jcfg, tcfg, jp, tp = _model(arch)
    prompts = _tokens(tcfg, b, s, 3)
    want = JEngine(jp, jcfg, JServeConfig(max_new_tokens=6)).generate(prompts)
    got = Engine(tp, tcfg, ServeConfig(max_new_tokens=6), device="cpu").generate(prompts)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,preset", [(DEEPSEEK, "smoke"), (LLAMA4, "smoke"), (LLAMA4, "100m")],
                         ids=[DEEPSEEK, LLAMA4, f"{LLAMA4}-100m"])
def test_serve_cli_runs_the_moe_families(arch, preset, capsys):
    """``--preset 100m`` (8 layers of 4 experts, d_model 512) is the preset
    that serves llama4 on one card: ``--preset full`` does not fit."""
    assert t_serve.main(["--arch", arch, "--preset", preset, "--batch", "2", "--prompt-len", "12",
                         "--new-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(rf"serve_done arch={arch} batch=2 new_tokens=3 .*tok_per_s=", out)


"""Sharded serving in ``repro_torch`` on the CPU: ``Engine(rules=)``,
``lm.prefill``/``decode_step`` under a mesh with split-KV caches, and the
SSM, hybrid and encoder-decoder kinds under a model axis, on spawned gloo
ranks (``test_torch_tp.run_grid``: one spawn of D × M ranks per grid runs
every case), held against the port's one-rank run and against the JAX
package's sharded serving.

Grids ``(data, model)`` = (1, 2), (2, 1) and (2, 2). Smoke configs in
float32 on the reference's weights (``PRNGKey(0)``): granite-3-2b (and its
int8 KV cache), gemma3-12b (one windowed group of window 8, decoded past
it), llama4-scout-17b-a16e and deepseek-v2-lite-16b (MoE, MLA), whisper-base
(frames from a seeded generator), mamba2-370m and zamba2-2.7b; B=4 prompts
of 8 tokens, 6 greedy new tokens (positions 8-13 of a 14-position cache:
7 per model rank). A granite form with 16 KV heads (``wk``/``wv`` sharded
over ``model``, the K/V all-gathered for the caches) runs on the port's own
weights against one rank only.

What is held, with the tolerances:

* tokens: equal on every rank, equal to the one-rank port's, and equal to
  the reference's under the same mesh on 4 fake XLA devices in a
  subprocess (``_SHARDED_REFERENCE``, run beside the grids): its
  ``Engine(rules=)`` for five families, and for mamba2 and zamba2 its
  ``prefill`` plus a loop of ``decode_step`` (its ``Engine`` fails on them,
  ROADMAP.md queue 3), zamba2's shared K/V padded by hand as
  ``tests/test_torch_attention.py`` pads them unsharded;
* the caches after the prefill (``lm.gather_caches``) and every step's
  logits (gathered over ``model`` and the batch ranks) within 1e-5 of the
  one-rank leaf's 2-norm (float32 sums split over ranks round apart: the
  row-parallel products, the split softmax of a decode step); the int8
  cache's values as dequantized;
* ``Engine`` with temperature 0.8 (seed 0) draws what one rank draws, and
  a batch of 3 over 2 data ranks (replicated) serves what one rank serves;
* ``moe_ffn`` at a decode step (T·k ≤ 256, dropless) and at a prefill with
  capacity drops (deepseek's experts, inputs offset by +0.5): the output
  within 1e-5 of its norm of one rank's, where (2, 2) routes each batch
  shard alone (``test_torch_tp.local_capacity``).
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.dist.sharding import (
    P,
    batch_rows,
    gather_over_model,
    gather_shard,
    local_shard,
    make_rules,
    shard_tree,
)
from repro_torch.models import lm
from repro_torch.models import moe as t_moe
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves
from test_torch_tp import ROOT, full_params, grid_id, local_capacity, run_grid

GRIDS = ((1, 2), (2, 1), (2, 2))
B, S, NEW = 4, 8, 6
NORM_TOL = 1e-5
#: Cases: name -> (arch, overrides). All but "granite-kv16" against the reference.
CASES = {
    "granite-3-2b": ("granite-3-2b", {}),
    "granite-int8": ("granite-3-2b", {"kv_quant": "int8"}),
    "gemma3-12b": ("gemma3-12b", {}),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
    "whisper-base": ("whisper-base", {}),
    "mamba2-370m": ("mamba2-370m", {}),
    "zamba2-2.7b": ("zamba2-2.7b", {}),
}
OWN_WEIGHTS = {"granite-kv16": ("granite-3-2b", {"n_heads": 16, "n_kv_heads": 16})}
MOE_ARCH = "deepseek-v2-lite-16b"


def case_cfg(name: str):
    arch, kw = {**CASES, **OWN_WEIGHTS}[name]
    return configs.smoke(arch).with_overrides(**kw)


def inputs(cfg, b=B):
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)[:b]
    enc = (np.random.default_rng(1).standard_normal((B, cfg.enc_len, cfg.d_model))
           .astype(np.float32)[:b] if cfg.enc_dec else None)
    return prompts, enc


# ---------------------------------------------------------------------------
# on a rank (and, with the one-rank rules, in this process)
# ---------------------------------------------------------------------------


def _gathered(logits, rules, rows, vocab):
    """Every row and vocabulary column of a (B_rank, V_rank) logits block
    (not the padding's float32 minimum)."""
    return gather_shard(gather_over_model(logits, 1, rules), rows, rules)[:, :vocab]


def serve_by_hand(params, cfg, rules, prompts, enc, new):
    """``Engine.generate``'s greedy loop through ``lm.prefill`` and
    ``decode_step``: (the caches after the prefill, gathered, as float
    numpy leaves; every step's logits, gathered)."""
    rules, rows = batch_rows(len(prompts), rules)
    toks = local_shard(torch.from_numpy(prompts).long(), rows, rules)
    enc_t = None if enc is None else local_shard(torch.from_numpy(enc), rows, rules)
    total = S + new
    with torch.no_grad():
        logits, caches = lm.prefill(params, toks, cfg, rules, max_seq=total, enc_in=enc_t)
        full = lm.gather_caches(caches, cfg, rules, max_seq=total)
        got = [_dequantized(name, t, full) for name, t in tree_flatten_with_names(full)]
        steps = [_gathered(logits, rules, rows, cfg.vocab)]
        tok = torch.argmax(gather_over_model(logits, 1, rules), dim=-1)
        for i in range(new):
            pos = torch.full((toks.shape[0],), S + i, dtype=torch.int64)
            logits, caches = lm.decode_step(params, tok, caches, pos, cfg, rules)
            steps.append(_gathered(logits, rules, rows, cfg.vocab))
            tok = torch.argmax(gather_over_model(logits, 1, rules), dim=-1)
    return got, [t.numpy() for t in steps]


def _dequantized(name, t, tree):
    """A cache leaf as float numpy: an int8 leaf times its scales (the next
    leaf of its four-tuple), the scales themselves as floats."""
    if t.dtype != torch.int8:
        return t.float().numpy().copy()  # the decode steps write the caches in place
    leaves = dict(tree_flatten_with_names(tree))
    prefix, idx = name.rsplit("/", 1)
    return (t.float() * leaves[f"{prefix}/{int(idx) + 1}"].float()[..., None]).numpy()


def job_serve(mesh, name: str, leaves: dict, new: int = NEW, b: int = B,
              temperature: float = 0.0, by_hand: bool = True):
    """On this rank: ``Engine(rules=).generate`` of the case, then (greedy,
    ``by_hand``) its loop through ``prefill``/``decode_step``. Rank 0
    returns all of it, every rank its tokens."""
    cfg = case_cfg(name)
    rules = make_rules(cfg, mesh)
    params = shard_tree(full_params(cfg, leaves), lm.param_specs(cfg), rules)
    prompts, enc = inputs(cfg, b)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=new, temperature=temperature),
                 device="cpu", rules=rules)
    out = {"tokens": eng.generate(prompts, enc=enc), "rules": (rules.batch_axes, rules.model_axis)}
    if by_hand:
        out["caches"], out["logits"] = serve_by_hand(params, cfg, rules, prompts, enc, new)
    return out if dist.get_rank() == 0 else {"tokens": out["tokens"]}


def random_caches(cfg):
    """A one-rank cache tree of B rows and S + NEW positions, every leaf
    filled from a seeded generator."""
    gen = torch.Generator().manual_seed(5)
    caches = lm.init_cache(cfg, B, S + NEW, dtype=torch.float32, device="cpu")
    for t in tree_leaves(caches):
        t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    return caches


def _np(t):
    """A tensor as numpy, bfloat16 as float32 (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def job_round_trip(mesh, name: str):
    """``lm.local_caches`` of ``random_caches`` on this rank (each leaf's
    shape), then ``gather_caches`` (rank 0)."""
    cfg = case_cfg(name)
    rules = make_rules(cfg, mesh)
    local = lm.local_caches(random_caches(cfg), cfg, rules)
    back = lm.gather_caches(local, cfg, rules, max_seq=S + NEW)
    out = {"shapes": [(n, tuple(t.shape)) for n, t in tree_flatten_with_names(local)],
           "gathered": [_np(t) for t in tree_leaves(back)]}
    return out if dist.get_rank() == 0 else None


def moe_inputs(cfg, t: int):
    return (np.random.default_rng(t).standard_normal((B, t, cfg.d_model)) + 0.5).astype(np.float32)


def job_moe(mesh, leaves: dict, t: int):
    """``moe_ffn`` of deepseek's first MoE layer under this mesh on
    ``moe_inputs``: the output gathered over the batch ranks, the aux."""
    cfg = configs.smoke(MOE_ARCH)
    rules = make_rules(cfg, mesh)
    params = shard_tree(full_params(cfg, leaves), lm.param_specs(cfg), rules)
    rows = P(tuple(rules.batch_axes))
    x = local_shard(torch.from_numpy(moe_inputs(cfg, t)), rows, rules)
    with torch.no_grad():
        out, aux = t_moe.moe_ffn(params["groups"][0]["pos0"]["moe"], x, cfg, rules)
        out = gather_shard(out, rows, rules)
    return {"out": out.numpy(), "aux": float(aux)}


# ---------------------------------------------------------------------------
# the one-rank runs and the references (in this process)
# ---------------------------------------------------------------------------


@functools.cache
def weights(name: str) -> dict:
    """The port's named numpy leaves: the reference's float32 weights from
    ``PRNGKey(0)`` (a reference case), else the port's own from seed 0."""
    cfg = case_cfg(name)
    if name in OWN_WEIGHTS:
        tp = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        return {n: t.numpy() for n, t in tree_flatten_with_names(tp)}
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.models import lm as j_lm
    from repro_torch.models.convert import params_from_numpy

    arch, kw = CASES[name]
    jcfg = j_configs.smoke(arch).with_overrides(**kw)
    jp = jax.jit(lambda k: j_lm.init_params(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return {n: t.numpy() for n, t in tree_flatten_with_names(tp)}


@functools.cache
def one_rank(name: str, b: int = B, temperature: float = 0.0) -> dict:
    from repro_torch.dist.sharding import NO_SHARDING

    cfg = case_cfg(name)
    params = full_params(cfg, weights(name))
    prompts, enc = inputs(cfg, b)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=NEW, temperature=temperature),
                 device="cpu")
    out = {"tokens": eng.generate(prompts, enc=enc)}
    out["caches"], out["logits"] = serve_by_hand(params, cfg, NO_SHARDING, prompts, enc, NEW)
    return out


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
from repro.serve.engine import Engine, ServeConfig


def loop(p, cfg, rules, prompts):
    # prefill, the shared block's K/V padded by hand, greedy decode steps
    b, s = prompts.shape
    logits, caches = jax.jit(lambda p, t: lm.prefill(p, t, cfg, rules))(p, jnp.asarray(prompts))
    for i, kind in enumerate(lm.group_layout(cfg)):
        if kind == "hybrid_attn":  # (G, B, S, KV, dh)
            caches["groups"][f"pos{i}"] = tuple(
                jnp.pad(a, ((0, 0), (0, 0), (0, NEW), (0, 0), (0, 0)))
                for a in caches["groups"][f"pos{i}"])
    step = jax.jit(lambda p, t, c, q: lm.decode_step(p, t, c, q, cfg, rules))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = []
    for i in range(NEW):
        out.append(np.asarray(tok))
        logits, caches = step(p, tok, caches, jnp.full((b,), s + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return np.stack(out, axis=1)


out = {}
for name, (arch, kw) in CASES.items():
    cfg = configs.smoke(arch).with_overrides(**kw)
    p = jax.jit(lambda k: lm.init_params(k, cfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = (jnp.asarray(np.random.default_rng(1).standard_normal((B, cfg.enc_len, cfg.d_model))
                       .astype(np.float32)) if cfg.enc_dec else None)
    for grid in GRIDS:
        mesh = make_local_mesh(*grid)
        rules = make_rules(cfg, mesh)
        with jax.set_mesh(mesh):
            if cfg.family in ("ssm", "hybrid"):
                toks = loop(p, cfg, rules, prompts)
            else:
                eng = Engine(p, cfg, ServeConfig(max_new_tokens=NEW), rules=rules)
                toks = eng.generate(prompts, enc=enc)
        out[f"{name}/{grid[0]}x{grid[1]}"] = np.asarray(toks).tolist()
print(json.dumps(out))
"""


def start_reference():
    """The reference's sharded tokens, per case and grid, in a subprocess
    on 4 fake XLA devices (the device count is fixed before JAX starts);
    ``finish_reference`` reads them."""
    code = (f"CASES, GRIDS, B, S, NEW = {CASES!r}, {GRIDS!r}, {B}, {S}, {NEW}\n"
            + textwrap.dedent(_SHARDED_REFERENCE))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env={**os.environ, "JAX_PLATFORMS": "cpu"})


def finish_reference(proc) -> dict:
    import json

    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return {k: np.asarray(v) for k, v in json.loads(stdout.strip().splitlines()[-1]).items()}


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"ranks": {grid: [rank dicts]}, "reference": {case/grid: tokens}}."""
    proc = start_reference()
    try:
        moe_leaves = weights(MOE_ARCH)
        jobs = [(name, job_serve, {"name": name, "leaves": weights(name)})
                for name in {**CASES, **OWN_WEIGHTS}]
        jobs += [("temperature", job_serve, {"name": "granite-3-2b", "temperature": 0.8,
                                             "leaves": weights("granite-3-2b"), "by_hand": False}),
                 ("batch3", job_serve, {"name": "granite-3-2b", "b": 3,
                                        "leaves": weights("granite-3-2b")}),
                 ("moe_decode", job_moe, {"leaves": moe_leaves, "t": 1}),
                 ("moe_prefill", job_moe, {"leaves": moe_leaves, "t": 80})]
        jobs += [(f"round_trip/{name}", job_round_trip, {"name": name})
                 for name in ("granite-int8", "deepseek-v2-lite-16b", "whisper-base",
                              "zamba2-2.7b")]
        ranks = {grid: run_grid(grid, jobs, tmp_path_factory.mktemp(f"serve{grid_id(grid)}"))
                 for grid in GRIDS}
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return {"ranks": ranks, "reference": finish_reference(proc)}


def _hold_norm(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        w = w.astype(np.float64)
        diff = float(np.linalg.norm(g.astype(np.float64) - w))
        assert diff <= NORM_TOL * float(np.linalg.norm(w)) + 1e-30, (what, i, diff,
                                                                     float(np.linalg.norm(w)))


@pytest.mark.parametrize("name", list(CASES) + list(OWN_WEIGHTS))
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_sharded_serving_equals_one_rank(served, grid, name):
    ranks = served["ranks"][grid]
    for r in ranks:  # every rank returns the whole batch's tokens
        np.testing.assert_array_equal(r[name]["tokens"], ranks[0][name]["tokens"])
    got, want = ranks[0][name], one_rank(name)
    assert got["tokens"].shape == (B, NEW)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    _hold_norm(got["caches"], want["caches"], "caches after the prefill")
    _hold_norm(got["logits"], want["logits"], "logits")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_sharded_tokens_equal_the_reference(served, grid, name):
    got = served["ranks"][grid][0][name]["tokens"]
    np.testing.assert_array_equal(got, served["reference"][f"{name}/{grid_id(grid)}"])


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_temperature_and_replicated_batch_equal_one_rank(served, grid):
    ranks = served["ranks"][grid]
    want_t = one_rank("granite-3-2b", temperature=0.8)["tokens"]
    want_3 = one_rank("granite-3-2b", b=3)
    assert not np.array_equal(want_t, one_rank("granite-3-2b")["tokens"])  # it samples
    for r in ranks:
        np.testing.assert_array_equal(r["temperature"]["tokens"], want_t)
        np.testing.assert_array_equal(r["batch3"]["tokens"], want_3["tokens"])
    got = ranks[0]["batch3"]
    _hold_norm(got["caches"], want_3["caches"], "caches, B=3")
    _hold_norm(got["logits"], want_3["logits"], "logits, B=3")


def _moe_one_rank(t: int, grid):
    from repro_torch.dist.sharding import NO_SHARDING

    cfg = configs.smoke(MOE_ARCH)
    params = full_params(cfg, weights(MOE_ARCH))["groups"][0]["pos0"]["moe"]
    x = torch.from_numpy(moe_inputs(cfg, t))
    ffn = local_capacity(grid[0]) if grid == (2, 2) else t_moe.moe_ffn
    with torch.no_grad():
        out, aux = ffn(params, x, cfg, NO_SHARDING)
    return out.numpy(), float(aux)


def _drops(t: int, shards: int) -> int:
    """Assignments past capacity when each of ``shards`` blocks of the batch
    routes alone."""
    cfg = configs.smoke(MOE_ARCH)
    router = torch.from_numpy(weights(MOE_ARCH)["groups/0/pos0/moe/router"])
    dropped = 0
    for part in torch.from_numpy(moe_inputs(cfg, t)).chunk(shards, 0):
        x2d = part.reshape(-1, cfg.d_model)
        _, _, eids = t_moe.route(router, x2d, cfg.top_k)
        pos = t_moe.arrival(eids.reshape(-1), cfg.n_experts)
        dropped += int((pos >= t_moe.capacity(x2d.shape[0], cfg)).sum())
    return dropped


@pytest.mark.parametrize("job,t", [("moe_decode", 1), ("moe_prefill", 80)])
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_moe_ffn_sharded_at_decode_and_with_drops(served, grid, job, t):
    got = served["ranks"][grid][0][job]
    want, aux = _moe_one_rank(t, grid)
    _hold_norm([got["out"]], [want], job)
    np.testing.assert_allclose(got["aux"], aux, rtol=NORM_TOL)
    shards = grid[0] if grid == (2, 2) else 1
    assert (_drops(t, shards) > 0) == (t > 1), (grid, t)


def test_rules_of_each_grid(served):
    for grid, ranks in served["ranks"].items():
        d, m = grid
        for name in CASES:
            batch_axes, model_axis = ranks[0][name]["rules"]
            assert batch_axes == (("data",) if d > 1 else ())
            assert model_axis == ("model" if m > 1 else None)


@pytest.mark.parametrize("name", ["granite-int8", "deepseek-v2-lite-16b", "whisper-base",
                                  "zamba2-2.7b"])
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_local_caches_cut_and_gather_back(served, grid, name):
    """``lm.local_caches`` of a one-rank cache tree: L = ceil(14 / M)
    positions of every split-KV leaf, the rank's SSM heads and conv
    channels; ``gather_caches`` gives the tree back bit for bit."""
    got = served["ranks"][grid][0][f"round_trip/{name}"]
    cfg = case_cfg(name)
    d, m = grid
    full = random_caches(cfg)
    for (path, shape), (_, t) in zip(got["shapes"], tree_flatten_with_names(full)):
        want = list(t.shape)
        want[0] //= d
        if "cross" not in path and t.ndim >= 3 and t.shape[1] == S + NEW:
            want[1] = -(-(S + NEW) // m)
        if cfg.family in ("ssm", "hybrid") and t.ndim == 4 and t.shape[1] == cfg.n_ssm_heads:
            want[1] //= m
        if t.ndim == 3 and t.shape[1] == cfg.ssm_conv - 1:
            want[2] = cfg.d_inner // m + 2 * cfg.ssm_state
        assert list(shape) == want, (path, shape, want)
    for a, (_, b) in zip(got["gathered"], tree_flatten_with_names(full)):
        np.testing.assert_array_equal(a, _np(b))

"""The threshold state machine (paper Algorithms 4-6) and the host driver of
``repro_torch`` on the CPU, held against ``repro`` on numpy-seeded inputs:
``find_root_threshold``, ``causal_order`` under ``order_backend="host"``
and ``"scan"`` on the cases of ``tests/test_threshold_scan.py``, and
``fit_batch(threshold=True)`` with the padding seams.

Tolerances and what is held equal:

* Roots, comparison counts, round counts and convergence flags are held
  equal to ``repro``'s. They follow from comparisons of partial scores with
  gamma, and both packages compute those scores from the same float32
  formulas (summed in other orders).
* Finished scores are held to ``fused_score.score_tolerance``: float32
  rounding of each entropy carried through I and S = sum min(0, I)^2, summed
  over every live pair, which bounds the partial sums of the threshold
  machine too. Rows that never ran (dead) are +inf on both sides.
* The p=64 fixture of ``test_scan_threshold_parity`` (seed 64, the host
  driver) is held to ``repro``'s float32 order, not to the float64 oracle
  (ROADMAP.md queue 3). The two float32 orders split at iteration 36, the
  near-tie logged there, where the port picks the oracle's root. The split
  is accepted only as a float32 split in which the port's correlation state
  is no farther from float64 than ``repro``'s (the rule of
  ``tests/test_torch_fit_batch.py``). Before it, every iteration's
  comparison count is equal; in 3 of those 36 iterations the port runs one
  more gamma growth round, because its float32 state (normalize, covariance
  and updates round differently from XLA's) puts a score on the other side
  of gamma. Given ``repro``'s own inputs of those iterations, the port's
  state machine gives ``repro``'s root and counters. The threshold order
  equals the port's dense order throughout.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro  # noqa: E402
from repro.core import covariance as j_cov  # noqa: E402
from repro.core import sem  # noqa: E402
from repro.core.paralingam import causal_order as j_causal_order  # noqa: E402
from repro.core.paralingam import find_root_threshold as j_find_root_threshold  # noqa: E402
from repro.core.paralingam import _update_iteration as j_update_iteration  # noqa: E402
from repro.core.paralingam import fit_batch as j_fit_batch  # noqa: E402
from repro.utils.shapes import next_pow2  # noqa: E402
from repro_torch.core import covariance as t_cov  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
import repro_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(p, n, seed):
    return sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]


def _cfg(**kw):
    ref = repro.ParaLiNGAMConfig(**kw)
    return ref, tp.config_from_reference(dataclasses.asdict(ref))


def _inputs(p, n, seed):
    """Normalized rows and correlations from the JAX package, as numpy, and
    a mask with one dead row from p=17 on."""
    xn = jax.jit(j_cov.normalize)(jnp.asarray(_gen(p, n, seed), jnp.float32))
    c = jax.jit(j_cov.cov_matrix)(xn)
    mask = np.ones(p, bool)
    if p >= 17:
        mask[p // 3] = False
    return np.array(xn), np.array(c), mask


@pytest.mark.parametrize("gamma0", [1e-6, 1e-5])
@pytest.mark.parametrize("chunk", [2, 16])
@pytest.mark.parametrize("p", [8, 17, 33])
def test_find_root_threshold_matches_reference(p, chunk, gamma0):
    xn, c, mask = _inputs(p, 600, seed=p)
    ref = j_find_root_threshold(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                                gamma0, 2.0, chunk=chunk)
    root, s, comps, rounds, conv = tp.find_root_threshold(xn, c, mask, gamma0, 2.0,
                                                          chunk=chunk, device="cpu")
    assert (int(root), int(comps), int(rounds), bool(conv)) == (
        int(ref[0]), int(ref[2]), int(ref[3]), bool(ref[4]))
    s_ref = torch.from_numpy(np.array(ref[1]))
    m = torch.from_numpy(mask)
    assert torch.equal(torch.isinf(s), torch.isinf(s_ref))
    tol = fs.score_tolerance(s_ref, torch.from_numpy(xn), torch.from_numpy(c), m)
    assert torch.all((s - s_ref)[m].abs() <= tol[m])


@pytest.mark.parametrize("live", [0, 1])
def test_fewer_than_two_live_rows_converge_without_rounds(live):
    xn, c, _ = _inputs(8, 300, seed=1)
    mask = np.arange(8) < live
    root, s, comps, rounds, conv = tp.find_root_threshold(xn, c, mask, 1e-5, 2.0,
                                                          device="cpu")
    assert (int(comps), int(rounds), bool(conv)) == (0, 0, True)
    assert int(root) == 0


@pytest.mark.parametrize("order_backend", ["host", "scan"])
def test_max_rounds_warns_and_reports_not_converged(order_backend):
    x = _gen(8, 800, seed=5)
    _, cfg = _cfg(order_backend=order_backend, threshold=True, chunk=2,
                  max_rounds=1, min_bucket=8)
    with pytest.warns(UserWarning, match="max_rounds"):
        res = repro_torch.core.causal_order(x, cfg, device="cpu")
    assert not res.converged
    assert all(it["rounds"] <= 1 for it in res.per_iteration)


def test_counters_do_not_depend_on_host_read_interval(monkeypatch):
    """A bucket of three datasets, one with a single live row: every output
    of the state machine is identical whether the host reads the running
    flag after every round or every fifth; the reads are fewer."""
    rows = [_inputs(16, 500, seed=s) for s in (2, 3, 4)]
    xb = torch.from_numpy(np.stack([r[0] for r in rows]))
    cb = torch.from_numpy(np.stack([r[1] for r in rows]))
    mb = torch.from_numpy(np.stack([r[2] for r in rows]))
    mb[2] = torch.arange(16) == 3
    reads = []
    orig = tp._still_running
    monkeypatch.setattr(tp, "_still_running", lambda run: reads.append(1) or orig(run))
    outs = {}
    for k in (1, 5):
        reads.clear()
        outs[k] = tp._find_root_threshold_impl(xb, cb, mb, 1e-6, 2.0, chunk=4,
                                               read_every=k)
        outs[k] = (*outs[k], len(reads))
    for a, b in zip(outs[1][:5], outs[5][:5]):
        assert torch.equal(a, b)
    rounds = int(outs[1][3].max())
    assert rounds > 5 and outs[1][3][2] == 0 and outs[1][2][2] == 0
    assert outs[1][5] == rounds + 1 and outs[5][5] == -(-rounds // 5) + 1


def _records(res):
    return [(it["comparisons"], it["rounds"], it["converged"]) for it in res.per_iteration]


@pytest.mark.parametrize("order_backend", ["host", "scan"])
@pytest.mark.parametrize("p,n,min_bucket", [(8, 2500, 8), (17, 1800, 8)])
def test_causal_order_threshold_matches_reference(p, n, min_bucket, order_backend):
    ref_cfg, cfg = _cfg(order_backend=order_backend, threshold=True, chunk=16,
                        gamma0=1e-6, min_bucket=min_bucket)
    x = _gen(p, n, seed=p)
    ref = j_causal_order(x, ref_cfg)
    res = repro_torch.core.causal_order(x, cfg, device="cpu")
    assert res.order == ref.order
    assert res.per_iteration == ref.per_iteration
    assert (res.comparisons, res.rounds, res.converged) == (
        ref.comparisons, ref.rounds, ref.converged)


def _corr_drift(x, roots, ref: bool):
    """Largest distance of a float32 correlation state (the port's or
    ``repro``'s) after ``roots`` from the float64 run of the same updates,
    over the rows still live."""
    p = x.shape[0]
    live = np.ix_(*[np.setdiff1d(np.arange(p), roots)] * 2)

    def port(dtype):
        xn = t_cov.normalize(torch.from_numpy(np.array(x)).to(dtype))
        c, m = t_cov.cov_matrix(xn), torch.ones(p, dtype=torch.bool)
        for r in roots:
            xn, c = t_cov.update_data(xn, c, r, m), t_cov.update_cov(c, r, m)
            m[r] = False
        return c.double().numpy()

    if ref:
        xn = j_cov.normalize(jnp.asarray(x, jnp.float32))
        c, m = j_cov.cov_matrix(xn), jnp.ones(p, bool)
        for r in roots:
            xn, c = j_cov.update_data(xn, c, r, m), j_cov.update_cov(c, r, m)
            m = m.at[r].set(False)
        c32 = np.asarray(c, np.float64)
    else:
        c32 = port(torch.float32)
    return np.abs(c32[live] - port(torch.float64)[live]).max()


def _ref_bucket_inputs(x, order, iters, min_bucket):
    """``repro``'s own find-root inputs (bucket rows, correlations, mask) of
    the host driver at the iterations ``iters``, replayed along ``order``."""
    p = x.shape[0]
    xn = j_cov.normalize(jnp.asarray(x, jnp.float32))
    c, mask = j_cov.cov_matrix(xn), jnp.ones(p, bool)
    live, out = np.ones(p, bool), {}
    for it in range(max(iters) + 1):
        idx = np.flatnonzero(live)
        m = min(max(min_bucket, next_pow2(len(idx))), next_pow2(p))
        pad = np.concatenate([idx, np.full(m - len(idx), idx[0])])
        if it in iters:
            out[it] = (np.array(xn)[pad], np.array(c)[np.ix_(pad, pad)],
                       np.arange(m) < len(idx))
        xn, c, mask = j_update_iteration(xn, c, jnp.asarray(order[it]), mask)
        live[order[it]] = False
    return out


def test_p64_fixture_held_to_reference_float32_order():
    ref_cfg, cfg = _cfg(threshold=True, chunk=16, gamma0=1e-6, min_bucket=32)
    x = _gen(64, 1000, seed=64)
    ref = j_causal_order(x, ref_cfg)
    res = repro_torch.core.causal_order(x, cfg, device="cpu")
    dense = repro_torch.core.causal_order(x, dataclasses.replace(cfg, threshold=False),
                                          device="cpu")
    assert res.order == dense.order and res.converged
    assert res.comparisons < res.comparisons_dense
    k = next((i for i, (a, b) in enumerate(zip(res.order, ref.order)) if a != b),
             len(ref.per_iteration))
    if k < len(ref.per_iteration):
        assert _corr_drift(x, res.order[:k], ref=False) <= _corr_drift(x, res.order[:k], ref=True)
    # Before the split the comparisons agree; a round count can differ by a
    # gamma growth where the two float32 states put a score on either side
    # of gamma. Given repro's own inputs there, the counters agree.
    assert [it["comparisons"] for it in res.per_iteration[:k]] == [
        it["comparisons"] for it in ref.per_iteration[:k]]
    differ = [i for i in range(k) if _records(res)[i] != _records(ref)[i]]
    for i, (xb, cb, mb) in _ref_bucket_inputs(x, ref.order, differ, 32).items():
        want = j_find_root_threshold(jnp.asarray(xb), jnp.asarray(cb), jnp.asarray(mb),
                                     1e-6, 2.0, chunk=16)
        got = tp.find_root_threshold(xb, cb, mb, 1e-6, 2.0, chunk=16, device="cpu")
        assert [int(v) for j, v in enumerate(got) if j != 1] == [
            int(v) for j, v in enumerate(want) if j != 1], i


@pytest.mark.parametrize("p", [8, 17])
def test_fit_batch_threshold_matches_fits_and_reference(p):
    """Ragged datasets zero-padded into one bucket (``n_valid`` and mask):
    each dataset's order and counters equal its own one-dataset fit and
    ``repro.fit_batch(threshold=True)`` on the same padded inputs."""
    ref_cfg, cfg = _cfg(threshold=True, chunk=4, gamma0=1e-6, min_bucket=8)
    shapes = [(p, 600), (p - 2, 450), (p - 5, 500)]
    xs = np.zeros((3, p, 600), np.float32)
    mask = np.zeros((3, p), bool)
    nv = np.array([n for _, n in shapes], np.int32)
    raw = []
    for i, (q, n) in enumerate(shapes):
        raw.append(_gen(q, n, seed=10 * p + i))
        xs[i, :q, :n] = raw[-1]
        mask[i, :q] = True
    res = repro_torch.fit_batch(xs, cfg, n_valid=nv, mask=mask, device="cpu")
    ref = j_fit_batch(xs, ref_cfg, n_valid=nv, mask=mask)
    for name in ("orders", "comparisons", "rounds", "converged"):
        got, want = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
        for i, (q, _) in enumerate(shapes):
            assert got[i, :q].tolist() == want[i, :q].tolist(), (name, i)
    for i, (q, n) in enumerate(shapes):
        one = repro_torch.fit_batch(xs[i:i + 1], cfg, n_valid=nv[i:i + 1],
                                    mask=mask[i:i + 1], device="cpu")
        for name in ("orders", "comparisons", "rounds", "converged"):
            assert torch.equal(getattr(one, name)[0], getattr(res, name)[i]), (name, i)
        fit, _ = repro_torch.fit(raw[i], cfg, device="cpu")
        assert fit.order == res.orders[i, :q].tolist()
    assert bool(res.converged.all())

"""``repro_torch.fit_batch`` / ``causal_order_batch`` on the CPU, held against
the port's own per-dataset ``fit``, ``repro.fit_batch`` and the float64
serial oracle on the inputs of ``tests/test_fit_batch.py``, plus the
warm-up entry, the dispatch counters and the refusals.

Tolerances:

* Against the port's own ``fit``: equal orders, B to 1e-5 absolute, noise
  variances to 1e-5 relative (the batched ops round as the one-dataset ops
  do on the CPU; the largest differences measured are 0).
* Against ``repro``: equal orders. Where an order differs, the first
  differing iteration must be a float32 split of the trajectory, not a fault
  of the port: on the roots both packages share up to there, the port's
  float32 correlation state is no farther from the float64 run of the same
  updates than ``repro``'s is (ROADMAP.md queue 3 logs the one such case,
  p=64 seed 6400). Where the orders agree, B is held twice:

  - against the float64 B of the same order (the same closed form run on
    float64 samples): the port's error is at most twice ``repro``'s plus
    1e-5. Measured: at most 5.2e-6 (port) and 3.7e-6 (repro) for p <= 17;
    1.8e-2 and 2.5e-2 at p=64, n=600, where cond(R) reaches 1.7e7;
  - against ``repro``'s B, to a limit per case set from the measured
    difference: 2e-4 for p <= 17 (measured 2.1e-6) and 3e-2 at p=64
    (measured 1.8e-2).

  The padded ragged case holds B to 2e-4, as the JAX test does.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro  # noqa: E402
from repro.core import covariance as j_cov  # noqa: E402
from repro.core import direct_lingam, sem  # noqa: E402
from repro.core.paralingam import causal_order_batch as j_causal_order_batch  # noqa: E402
from repro.core.paralingam import fit_batch as j_fit_batch  # noqa: E402
from repro_torch.core import covariance as t_cov  # noqa: E402
from repro_torch.core.adjacency import adjacency_from_order  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
import repro_torch  # noqa: E402

B_ATOL = 2e-4
B64_MARGIN, B64_FLOOR = 2.0, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(p, n, seed, density="sparse"):
    return sem.generate(sem.SemSpec(p=p, n=n, density=density, seed=seed))["x"]


def _cfg(**kw):
    ref = repro.ParaLiNGAMConfig(**kw)
    return ref, tp.config_from_reference(dataclasses.asdict(ref))


def _ref_corr_state(x, roots):
    """``repro``'s float32 correlation matrix after the updates of ``roots``."""
    xn = j_cov.normalize(jnp.asarray(x, jnp.float32))
    c, m = j_cov.cov_matrix(xn), jnp.ones(x.shape[0], bool)
    for r in roots:
        xn, c = j_cov.update_data(xn, c, r, m), j_cov.update_cov(c, r, m)
        m = m.at[r].set(False)
    return np.asarray(c, np.float64)


def _port_corr_state(x, roots, dtype):
    """The port's correlation matrix after the updates of ``roots``, at
    ``dtype``."""
    xn = t_cov.normalize(torch.from_numpy(np.array(x)).to(dtype))
    c, m = t_cov.cov_matrix(xn), torch.ones(x.shape[0], dtype=torch.bool)
    for r in roots:
        xn, c = t_cov.update_data(xn, c, r, m), t_cov.update_cov(c, r, m)
        m[r] = False
    return c.double().numpy()


def _assert_reference_order(order, ref_order, x):
    """Equal orders, or a float32 split at the first difference in which the
    port kept the closer trajectory (see the module docstring)."""
    if order == ref_order:
        return
    k = next(i for i, (a, b) in enumerate(zip(order, ref_order)) if a != b)
    roots = order[:k]
    live = np.ix_(*[np.setdiff1d(np.arange(x.shape[0]), roots)] * 2)
    c64 = _port_corr_state(x, roots, torch.float64)[live]
    drift_port = np.abs(_port_corr_state(x, roots, torch.float32)[live] - c64).max()
    drift_ref = np.abs(_ref_corr_state(x, roots)[live] - c64).max()
    assert drift_port <= drift_ref, (
        f"orders split at iteration {k} with the port farther from float64 "
        f"({drift_port:.3e}) than repro ({drift_ref:.3e})")


def _b_float64(x, order):
    """B of ``order`` from the same closed form on float64 samples."""
    b, _ = adjacency_from_order(torch.from_numpy(np.array(x, np.float64)),
                                torch.tensor(order))
    return b.numpy()


@pytest.mark.parametrize("p,n,min_bucket,b_limit",
                         [(8, 2000, 8, B_ATOL), (17, 1200, 8, B_ATOL), (64, 600, 32, 3e-2)])
def test_fit_batch_matches_fit_and_reference(p, n, min_bucket, b_limit):
    ref_cfg, cfg = _cfg(min_bucket=min_bucket)
    xs = np.stack([_gen(p, n, seed=100 * p + i) for i in range(3)])
    res = repro_torch.fit_batch(xs, cfg, device="cpu")
    ref = j_fit_batch(xs, ref_cfg)
    for i in range(xs.shape[0]):
        ri, bi = repro_torch.fit(xs[i], cfg, device="cpu")
        order = res.orders[i].tolist()
        assert order == ri.order
        np.testing.assert_allclose(res.b[i].numpy(), bi.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.noise_var[i].numpy(), ri.noise_var, rtol=1e-5)
        assert res.comparisons[i].sum().item() == ri.comparisons
        ref_order = np.asarray(ref.orders[i]).tolist()
        _assert_reference_order(order, ref_order, xs[i])
        if order == ref_order:
            b_port = res.b[i].numpy().astype(np.float64)
            b_ref = np.asarray(ref.b[i], np.float64)
            b64 = _b_float64(xs[i], order)
            err_port, err_ref = np.abs(b_port - b64).max(), np.abs(b_ref - b64).max()
            assert err_port <= B64_MARGIN * err_ref + B64_FLOOR, (
                f"dataset {i}: port B is {err_port:.3e} from the float64 B, "
                f"repro's {err_ref:.3e}")
            np.testing.assert_allclose(b_port, b_ref, rtol=0, atol=b_limit)
    assert bool(res.converged.all()) and int(res.rounds.sum()) == 0


def test_fit_batch_kernel_route_matches_plain():
    """``hopper_fused`` on the CPU runs the batched kernel's plain version
    through ``ops.score_batch``; it gives the orders of the square path."""
    xs = np.stack([_gen(17, 1200, seed=1700 + i) for i in range(3)])
    res_k = repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(min_bucket=8, score_backend="hopper_fused"),
                                  device="cpu")
    res_p = repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(min_bucket=8), device="cpu")
    assert torch.equal(res_k.orders, res_p.orders)
    assert torch.equal(res_k.b, res_p.b)


def _ragged(raw, p_pad, n_pad):
    xs = np.zeros((len(raw), p_pad, n_pad))
    mask = np.zeros((len(raw), p_pad), bool)
    nv = np.zeros((len(raw),), np.int32)
    for i, x in enumerate(raw):
        p, n = x.shape
        xs[i, :p, :n] = x
        mask[i, :p] = True
        nv[i] = n
    return xs, mask, nv


def test_fit_batch_padded_parity():
    """Ragged (p, n) datasets zero-padded into one (3, 32, 2048) bucket give
    the orders of dedicated unpadded ``repro`` fits, B within 2e-4, and an
    exactly zero padded tail."""
    ref_cfg, cfg = _cfg(order_backend="scan", min_bucket=8)
    raw = [_gen(17, 1800, seed=1), _gen(32, 2048, seed=2), _gen(8, 1000, seed=3)]
    xs, mask, nv = _ragged(raw, 32, 2048)
    res = repro_torch.fit_batch(xs, cfg, mask=mask, n_valid=nv, device="cpu")
    for i, x in enumerate(raw):
        p = x.shape[0]
        ri, bi = repro.fit(x, ref_cfg)
        assert res.orders[i, :p].tolist() == ri.order
        np.testing.assert_allclose(res.b[i, :p, :p].numpy(), np.asarray(bi), rtol=0, atol=B_ATOL)
        assert np.abs(res.b[i, p:, :].numpy()).sum() == 0.0
        assert np.abs(res.b[i, :, p:].numpy()).sum() == 0.0
        assert np.all(res.noise_var[i, p:].numpy() == 0.0)


def test_fit_batch_padded_orders_match_serial_oracle():
    x = _gen(17, 1500, seed=21)
    xs, mask, nv = _ragged([x], 32, 2048)
    res = repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(min_bucket=8), mask=mask,
                                n_valid=nv, device="cpu")
    assert res.orders[0, :17].tolist() == direct_lingam.causal_order(x)


def test_causal_order_batch_matches_reference():
    ref_cfg, cfg = _cfg(min_bucket=8)
    xs = np.stack([_gen(12, 900, seed=i + 7) for i in range(4)])
    res = repro_torch.causal_order_batch(xs, cfg, device="cpu")
    assert res.b is None and res.noise_var is None
    ref = j_causal_order_batch(xs, ref_cfg)
    assert res.orders.tolist() == np.asarray(ref.orders).tolist()
    assert res.comparisons.tolist() == np.asarray(ref.comparisons).tolist()


def test_fit_batch_rejects_wrong_rank():
    with pytest.raises(ValueError, match="B, p, n"):
        repro_torch.fit_batch(np.zeros((4, 5)), device="cpu")
    with pytest.raises(ValueError, match="B, p, n"):
        repro_torch.causal_order_batch(np.zeros((4, 5)), device="cpu")


def test_batch_rejects_ring_and_threshold_configs():
    """A ring config raises the reference's ``ConfigError`` in the batched
    entries, as ``repro.fit_batch`` does (the ring has no batched form); a
    threshold config runs the batched threshold machine, with real round
    counters."""
    xs = np.zeros((2, 4, 8))
    ring_ref, ring = _cfg(order_backend="ring")
    with pytest.raises(repro.core.paralingam.ConfigError, match="no batched form"):
        j_fit_batch(xs, ring_ref)
    with pytest.raises(tp.ConfigError, match="no batched form"):
        repro_torch.fit_batch(xs, ring, device="cpu")
    with pytest.raises(tp.ConfigError, match="no batched form"):
        repro_torch.causal_order_batch(xs, ring, device="cpu")
    with pytest.raises(tp.ConfigError, match="no batched form"):
        tp.aot_fit_batch(2, 4, 8, ring, device="cpu")
    ref_cfg, cfg = _cfg(threshold=True, min_bucket=8)
    assert cfg.threshold
    xs = np.stack([_gen(6, 400, seed=s) for s in (1, 2)])
    res = repro_torch.causal_order_batch(xs, cfg, device="cpu")
    ref = j_causal_order_batch(xs, ref_cfg)
    assert res.orders.tolist() == np.asarray(ref.orders).tolist()
    assert res.rounds.tolist() == np.asarray(ref.rounds).tolist()
    assert int(res.rounds.sum()) > 0 and bool(res.converged.all())


@pytest.mark.parametrize("entry", ["fit_batch", "causal_order_batch", "aot_fit_batch"])
def test_batch_entry_points_need_cuda_without_device(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (1, 3, 10) if entry == "aot_fit_batch" else (np.ones((1, 3, 10)),)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tp, entry)(*args)


def test_aot_fit_batch_warms_and_matches_fit_batch():
    cfg = tp.ParaLiNGAMConfig(min_bucket=8)
    exe = tp.aot_fit_batch(2, 16, 256, cfg, device="cpu")
    assert exe.compile_seconds > 0 and exe.backend == "torch"
    xs = np.stack([_gen(16, 256, seed=s) for s in (3, 4)]).astype(np.float32)
    nv, mask = np.array([256, 200], np.int32), np.ones((2, 16), bool)
    xs[1, :, 200:] = 0.0
    got = exe(torch.from_numpy(xs), n_valid=nv, mask=mask)
    want = repro_torch.fit_batch(xs, cfg, n_valid=nv, mask=mask, device="cpu")
    assert torch.equal(got.orders, want.orders) and torch.equal(got.b, want.b)
    with pytest.raises(ValueError, match="specialized"):
        exe(torch.zeros((1, 16, 256)))


def test_auto_downgrade_counted_per_dispatch():
    """On the CPU ``auto`` resolves to the plain torch path: every dispatch
    counts one ``auto_downgrade``; an explicit kernel backend counts none,
    and ``kernel_bypass`` stays 0, as does ``rank1_update`` (the update
    kernel's launches: on the CPU its wrapper runs the plain version)."""
    tp.reset_dispatch_stats()
    xs = np.stack([_gen(8, 128, seed=94 + i) for i in range(2)])
    repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(min_bucket=8), device="cpu")
    repro_torch.causal_order_batch(xs, tp.ParaLiNGAMConfig(min_bucket=8), device="cpu")
    repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(min_bucket=8, score_backend="hopper_fused"),
                          n_valid=np.array([128, 100]), device="cpu")
    assert tp.dispatch_stats_snapshot() == {"kernel_bypass": 0, "auto_downgrade": 2,
                                            "rank1_update": 0}
    tp.reset_dispatch_stats()
    assert tp.dispatch_stats_snapshot() == {"kernel_bypass": 0, "auto_downgrade": 0,
                                            "rank1_update": 0}


def test_dispatch_stats_concurrent_updates_are_exact():
    tp.reset_dispatch_stats()

    def bump():
        for _ in range(50):
            tp._bump_stat("auto_downgrade")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(not t.is_alive() for t in threads)
    assert tp.dispatch_stats_snapshot()["auto_downgrade"] == 8 * 50
    tp.reset_dispatch_stats()

"""The two p=64 near-tie fixtures of the float32 tests, in float64 on the
CPU: where the float32 orders depart from the float64 serial oracle
(``core/direct_lingam.causal_order``), the port's float64 runs, the JAX
package's float64 runs (under ``jax.enable_x64``, restored after each test)
and the oracle give one order.

* p=64, n=600, seed 6400 (``tests/test_torch_fit_batch.py``'s split, where
  the float32 orders of the port and of ``repro`` part at iteration 22):
  the port's dense ``fit``, host driver, ``fit_batch`` and ``torch_fused``
  fit, and ``repro``'s float64 ``fit``.
* p=64, n=1000, seed 64 (``tests/test_torch_threshold.py``'s threshold
  fixture, whose float32 orders part at the near-tie of iteration 36): the
  port's threshold host driver and dense ``torch_fused`` fit, and
  ``repro``'s float64 threshold host driver.

The oracle takes ~15 s per fixture here, the threshold host drivers ~20 s
each: this file is split from ``tests/test_torch_dtype.py`` so that the two
run on different workers.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
from repro.core import paralingam as j_pl  # noqa: E402
from repro_torch.core import direct_lingam, sem  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
import repro_torch  # noqa: E402

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _gen(p, n, seed):
    return sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]


def _cfgs(**kw):
    r = repro.ParaLiNGAMConfig(dtype=jax.numpy.float64, **kw)
    return r, tp.config_from_reference(dataclasses.asdict(r))


def test_fit_batch_split_fixture_gives_the_oracle_order(x64):
    x = _gen(64, 600, 6400)
    oracle = direct_lingam.causal_order(x)
    ref_cfg, cfg = _cfgs(min_bucket=32)
    assert repro.fit(x, ref_cfg)[0].order == oracle
    assert repro_torch.fit(x, cfg, **CPU)[0].order == oracle
    assert repro_torch.core.causal_order(x, cfg, **CPU).order == oracle
    assert repro_torch.fit_batch(x[None], cfg, **CPU).orders[0].tolist() == oracle
    fused = dataclasses.replace(cfg, score_backend="torch_fused")
    assert repro_torch.fit(x, fused, **CPU)[0].order == oracle


def test_threshold_fixture_gives_the_oracle_order(x64):
    x = _gen(64, 1000, 64)
    oracle = direct_lingam.causal_order(x)
    ref_cfg, cfg = _cfgs(threshold=True, chunk=16, gamma0=1e-6, min_bucket=32)
    want = j_pl.causal_order(x, ref_cfg)
    assert want.order == oracle
    res = repro_torch.core.causal_order(x, cfg, **CPU)
    assert res.order == oracle
    assert res.per_iteration == want.per_iteration
    assert res.comparisons < res.comparisons_dense
    fused = dataclasses.replace(cfg, threshold=False, score_backend="torch_fused")
    assert repro_torch.fit(x, fused, **CPU)[0].order == oracle

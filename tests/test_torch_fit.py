"""``repro_torch.fit`` end to end on the CPU, held against ``repro.fit`` and
the float64 serial oracle, plus the port's config mapping, its refusals and
its import isolation.

Tolerances for phase 2: B to 2e-4 absolute and the noise variances to 2e-4
relative. Both packages factor the same float32 correlation matrix (p <= 33)
whose entries differ by a few ulps between XLA's and torch's reductions, and
the Cholesky and the triangular solve amplify that. Over the 18 cases of
``test_fit_matches_reference`` the largest differences are 5.6e-5 (B) and
3.7e-5 (noise variance, relative), measured on the CPU.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.core import direct_lingam, sem  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
from repro_torch.core.validate import DatasetError  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
import repro_torch  # noqa: E402

B_ATOL, NV_RTOL = 2e-4, 2e-4
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_fit(x, cfg, **kw):
    return repro_torch.fit(x, tp.config_from_reference(dataclasses.asdict(cfg)),
                           device="cpu", **kw)


@pytest.mark.parametrize("backend", ["auto", "xla_fused"])
@pytest.mark.parametrize("p", [8, 17, 33])
def test_fit_matches_reference(p, backend):
    cfg = repro.ParaLiNGAMConfig(score_backend=backend)
    for seed in range(3):
        x = sem.generate(sem.SemSpec(p=p, n=600, density="sparse", seed=seed))["x"]
        ref, b_ref = repro.fit(x, cfg)
        res, b = _port_fit(x, cfg)
        assert res.order == ref.order, (p, seed)
        np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=0, atol=B_ATOL)
        np.testing.assert_allclose(res.noise_var, ref.noise_var, rtol=NV_RTOL)
        assert res.comparisons == ref.comparisons
        assert res.per_iteration == ref.per_iteration
        assert res.saving_vs_serial == pytest.approx(ref.saving_vs_serial)
        assert res.saving_vs_messaging == ref.saving_vs_messaging == 0.0


@pytest.mark.parametrize("backend", ["torch", "torch_fused", "hopper_fused"])
@pytest.mark.parametrize("seed", [0, 2])
def test_order_matches_serial_oracle(seed, backend):
    """The cases of test_fused_score.py::test_scan_order_matches_serial_oracle
    (``hopper_fused`` on the CPU runs the kernel's plain version)."""
    data = sem.generate(sem.SemSpec(p=8, n=2500, density="sparse", seed=seed))
    res, _ = repro_torch.fit(
        data["x"], tp.ParaLiNGAMConfig(score_backend=backend, min_bucket=8),
        device="cpu")
    assert res.order == direct_lingam.causal_order(data["x"])


def test_fit_accepts_tensor_and_prunes():
    x = sem.generate(sem.SemSpec(p=12, n=500, seed=1))["x"]
    res, b = repro_torch.fit(torch.from_numpy(x), prune_below=0.3, device="cpu",
                             validate=True)
    assert res.diagnostics.ok
    assert b.dtype == torch.float32 and b.device.type == "cpu"
    nz = b.numpy()[b.numpy() != 0]
    assert np.all(np.abs(nz) >= 0.3)


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_fit_restores_matmul_precision(precision):
    """The fit's products run at full float32 precision; the caller's
    setting comes back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        x = sem.generate(sem.SemSpec(p=6, n=200, seed=0))["x"]
        repro_torch.fit(x, device="cpu")
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)


def test_validate_rejects_nan():
    x = sem.generate(sem.SemSpec(p=6, n=200, seed=0))["x"]
    x[2, 7] = np.nan
    with pytest.raises(DatasetError, match="non-finite"):
        repro_torch.fit(x, validate=True, device="cpu")


def test_unported_options_raise():
    """Since the ring's port nothing raises for being unported: a ring
    config builds, and ``config_from_reference`` maps one (``ring_topology``
    included); the threshold machine builds, and maps from a reference
    config with all its settings. Unknown drivers still raise."""
    assert tp.ParaLiNGAMConfig(order_backend="ring").order_backend == "ring"
    ring = tp.config_from_reference(dataclasses.asdict(
        repro.ParaLiNGAMConfig(order_backend="ring", ring_topology=(2, 2))))
    assert (ring.order_backend, ring.ring_topology) == ("ring", (2, 2))
    with pytest.raises(tp.ConfigError):
        tp.ParaLiNGAMConfig(order_backend="bogus")
    assert tp.ParaLiNGAMConfig(threshold=True).threshold
    ref = repro.ParaLiNGAMConfig(threshold=True, chunk=4, gamma0=3e-6, gamma_growth=1.5,
                                 max_rounds=77, bucket=False, min_bucket=8)
    cfg = tp.config_from_reference(dataclasses.asdict(ref))
    names = ("threshold", "chunk", "gamma0", "gamma_growth", "max_rounds", "bucket",
             "min_bucket", "block_j")
    assert [getattr(cfg, k) for k in names] == [getattr(ref, k) for k in names]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = tp.config_from_reference(dataclasses.asdict(
            repro.ParaLiNGAMConfig(method="threshold")))
    assert (legacy.order_backend, legacy.threshold) == ("host", True)


def test_hopper_square_backend_unavailable():
    """``hopper`` (the square moments kernel) resolves, maps from
    ``pallas``, and fits on the CPU through the kernel's plain version with
    the order of the square plain path."""
    assert ops.select_backend("hopper", torch.device("cpu")) == "hopper"
    assert ops.select_backend("hopper", torch.device("cuda")) == "hopper"
    cfg = tp.config_from_reference(dataclasses.asdict(
        repro.ParaLiNGAMConfig(score_backend="pallas", min_bucket=8)))
    assert cfg.score_backend == "hopper"
    x = sem.generate(sem.SemSpec(p=9, n=700, density="sparse", seed=2))["x"]
    res, b = repro_torch.fit(x, cfg, device="cpu")
    plain, _ = repro_torch.fit(x, dataclasses.replace(cfg, score_backend="torch"),
                               device="cpu")
    assert res.order == plain.order
    assert bool(torch.all(torch.isfinite(b)))
    with pytest.raises(ops.BackendUnavailable):
        ops.select_backend("xla", torch.device("cpu"))


@pytest.mark.parametrize("device,want", [("cpu", "torch"), ("cuda", "hopper_fused")])
def test_auto_resolves_per_device(device, want):
    assert ops.select_backend("auto", torch.device(device)) == want
    assert ops.select_backend(tp.ParaLiNGAMConfig(), torch.device(device)) == want


@pytest.mark.parametrize("kw,want", [
    (dict(score_backend="xla"), ("host", "torch")),
    (dict(score_backend="pallas_fused", order_backend="scan"), ("scan", "hopper_fused")),
    (dict(use_kernel=False, fused=True), ("host", "torch_fused")),
    (dict(use_kernel=True, fused=True), ("host", "hopper_fused")),
    (dict(method="scan"), ("scan", "auto")),
    (dict(method="dense", block_j=16, min_bucket=8), ("host", "auto")),
])
def test_config_from_reference_maps_names(kw, want):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = repro.ParaLiNGAMConfig(**kw)
    cfg = tp.config_from_reference(dataclasses.asdict(ref))
    assert (cfg.order_backend, cfg.score_backend) == want
    assert (cfg.block_j, cfg.min_bucket) == (ref.block_j, ref.min_bucket)


def test_config_from_reference_refuses_legacy_ring_and_mixed_flags():
    """The legacy ``ring`` flag maps to the ring as the reference maps it
    (``ring=True`` with ``method="threshold"`` to the threshold ring); mixing
    it with a contrary ``order_backend`` still raises."""
    assert tp.config_from_reference({"ring": True}).order_backend == "ring"
    both = tp.config_from_reference({"ring": True, "method": "threshold"})
    assert (both.order_backend, both.threshold) == ("ring", True)
    with pytest.raises(tp.ConfigError, match="not both"):
        tp.config_from_reference({"ring": False, "order_backend": "ring"})
    with pytest.raises(tp.ConfigError, match="not both"):
        tp.config_from_reference({"use_kernel": True, "fused": True,
                                  "score_backend": "xla"})
    with pytest.raises(tp.ConfigError, match="float32"):
        tp.config_from_reference({"dtype": np.float16})


def test_fit_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.fit(np.ones((3, 10)))


def test_import_loads_no_jax_or_repro():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.kernels._build, repro_torch.serve, repro_torch.utils.clock, "
            "repro_torch.kernels.ref, repro_torch.models.lm, repro_torch.models.convert, "
            "repro_torch.launch.serve, repro_torch.configs, repro_torch.dist.ring, "
            "repro_torch.dist.ring_order, repro_torch.launch.mesh\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

import importlib.util
import os
import sys

import pytest

# Tests see the real device count (1 CPU). The dry-run-scale tests that need
# many devices spawn subprocesses with their own XLA_FLAGS.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Optional dev dependency (requirements-dev.txt): property tests need
# hypothesis; without it, skip collecting those modules instead of erroring
# the whole run (conftest-level importorskip).
_HYPOTHESIS_MODULES = ("test_covariance.py", "test_serve_storm.py")
collect_ignore = (
    [] if importlib.util.find_spec("hypothesis") else list(_HYPOTHESIS_MODULES)
)

# Subprocess-driven multi-device suites: each test spawns a fresh python with
# --xla_force_host_platform_device_count and recompiles from scratch — by far
# the slowest part of the suite. Marked ``slow`` so CI can run a fast
# ``-m "not slow"`` lane; the full lane still runs everything.
_SLOW_MODULES = {"test_distributed.py", "test_elastic.py"}


# -- deterministic serving-test fixtures -------------------------------------
# The async serving stack (serve/batching.py) seams all timing through
# utils.clock and all device work through the dispatch callable. These
# fixtures are the deterministic halves of those seams: a manually-advanced
# clock and a scriptable dispatcher, so deadline-flush, timeout, shed and
# fault-injection paths are tested with zero wall-clock sleeps.


@pytest.fixture
def fake_clock():
    from repro.utils.clock import FakeClock

    return FakeClock()


@pytest.fixture
def manual_dispatcher():
    from repro.serve.batching import ManualDispatcher

    return ManualDispatcher()


@pytest.fixture
def chaos_seed():
    """Seed of the chaos-matrix fault schedules (tests/test_replica.py,
    tests/test_serve_storm.py). The CI ``chaos`` lane randomizes it per run
    via the CHAOS_SEED env var; on failure pytest shows the captured print,
    so re-running with that CHAOS_SEED reproduces the exact storm."""
    seed = int(os.environ.get("CHAOS_SEED", "1337"))
    print(f"CHAOS_SEED={seed}")
    return seed


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: subprocess-based multi-device tests (excluded from the fast CI lane)",
    )
    config.addinivalue_line(
        "markers",
        "requires_multidevice(n): in-process test needing >= n JAX devices; "
        "auto-skipped when the backend has fewer (the CI `multidevice` lane "
        "forces 8 host devices via XLA_FLAGS so these run on every PR)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand-written kernels); skips "
        "without one. On the card: pytest -m cuda tests/test_torch_*.py",
    )


def pytest_collection_modifyitems(config, items):
    device_count = None  # resolved lazily: only init JAX if a test needs it
    for item in items:
        if os.path.basename(str(item.fspath)) in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        marker = item.get_closest_marker("requires_multidevice")
        if marker is not None:
            need = marker.args[0] if marker.args else 2
            if device_count is None:
                import jax

                device_count = jax.device_count()
            if device_count < need:
                item.add_marker(
                    pytest.mark.skip(
                        reason=f"needs {need} devices, have {device_count} "
                        "(run with XLA_FLAGS=--xla_force_host_platform_"
                        "device_count=8)"
                    )
                )

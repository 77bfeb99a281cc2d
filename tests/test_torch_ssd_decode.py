"""The port's SSD decode step (``kernels.ssd_decode``) on the CPU against the
JAX package's: its plain version and the wrapper's CPU route against
``repro.kernels.ssd_decode.ssd_decode`` (the Pallas kernel in interpret mode,
at head blocks 8 and 2) and ``ssd_decode_ref``, on the cases of
``tests/test_kernels.py::test_ssd_decode_kernel_matches_ref`` and a head
count that is not a multiple of 8 (against ``ssd_decode_ref`` only: the
Pallas wrapper needs H to be a multiple of its head block).

Tolerance: rtol and atol 1e-5, as ``tests/test_kernels.py`` holds the Pallas
kernel: the state update rounds alike on both sides, y's N-term sum is taken
in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_decode import ssd_decode as j_ssd_decode  # noqa: E402
from repro.kernels.ssd_decode import ssd_decode_ref as j_ssd_decode_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import ssd_decode as t_ssd  # noqa: E402

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(b, h, p, n):
    rng = np.random.default_rng(b * 100 + h)
    return [rng.standard_normal((b, h, p, n)).astype(np.float32),
            rng.standard_normal((b, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (b, h)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((h,)).astype(np.float32)]


def _port(fn, args):
    return [t.numpy() for t in fn(*[torch.from_numpy(a) for a in args])]


CASES = [(2, 16, 16, 16), (4, 32, 64, 128), (1, 8, 32, 64)]


@pytest.mark.parametrize("block_h", [8, 2])
@pytest.mark.parametrize("b,h,p,n", CASES)
def test_plain_matches_pallas_kernel(b, h, p, n, block_h):
    args = _inputs(b, h, p, n)
    y_j, s_j = j_ssd_decode(*map(jnp.asarray, args), block_h=min(block_h, h), interpret=True)
    for fn in (t_ssd.ssd_decode_ref, ops.ssd_decode):
        y_t, s_t = _port(fn, args)
        np.testing.assert_allclose(y_t, np.asarray(y_j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,p,n", CASES + [(3, 12, 16, 32), (2, 5, 8, 24), (2, 5, 24, 37)])
def test_plain_matches_reference_oracle(b, h, p, n):
    args = _inputs(b, h, p, n)
    y_j, s_j = j_ssd_decode_ref(*map(jnp.asarray, args))
    before = t_ssd.LAUNCHES
    for fn in (t_ssd.ssd_decode_ref, t_ref.ssd_decode_ref, ops.ssd_decode):
        y_t, s_t = _port(fn, args)
        assert y_t.shape == (b, h, p) and s_t.shape == (b, h, p, n)
        np.testing.assert_allclose(y_t, np.asarray(y_j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=RTOL, atol=ATOL)
    assert t_ssd.LAUNCHES == before  # CPU tensors take the plain version


def test_rows_do_not_depend_on_the_batch():
    """Row b of a batched call against a one-row call of row b: the state
    update is elementwise and bit-equal; y's N-sum is a torch einsum, whose
    CPU blocking may change with the batch, so it is held to the tolerance
    here (the kernel's rows are bit-identical: tests/test_torch_cuda.py).
    The input state is left as it was: a fresh state comes back."""
    args = [torch.from_numpy(a) for a in _inputs(4, 6, 8, 16)]
    keep = args[0].clone()
    y, s = ops.ssd_decode(*args)
    assert torch.equal(args[0], keep)
    for b in range(4):
        one = [t[b:b + 1] for t in args[:5]] + args[5:]
        y1, s1 = ops.ssd_decode(*one)
        assert torch.equal(s1[0], s[b])
        np.testing.assert_allclose(y1[0].numpy(), y[b].numpy(), rtol=RTOL, atol=ATOL)


def test_casts_to_float32_and_refuses_bad_shapes():
    args = [torch.from_numpy(a) for a in _inputs(2, 4, 8, 16)]
    y, s = ops.ssd_decode(args[0].double(), args[1].bfloat16(), *args[2:])
    assert y.dtype == s.dtype == torch.float32
    with pytest.raises(ValueError, match="want b"):
        ops.ssd_decode(*args[:3], args[3][:, :8], *args[4:])
    with pytest.raises(ValueError, match="want a"):
        ops.ssd_decode(*args[:5], args[5][:3], args[6])
    with pytest.raises(ValueError, match="state must be"):
        ops.ssd_decode(args[0][0], *args[1:])

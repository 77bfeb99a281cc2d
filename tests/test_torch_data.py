"""The port's synthetic data (``repro_torch.data.synthetic``) against the
JAX package's: ``TokenStream.batch_at`` bit for bit (the port carries the
reference's numpy code), its tensor on a device, ``lingam_batches``, and
the mirrors of ``tests/test_data.py`` (names with ``_port`` added)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.data.synthetic import lingam_batches as j_lingam_batches  # noqa: E402
from repro_torch.data.synthetic import TokenStream, lingam_batches  # noqa: E402


@pytest.mark.parametrize("vocab,batch,seq,seed", [(1000, 4, 16, 42), (512, 8, 128, 0),
                                                  (49155, 8, 128, 0), (51865, 2, 33, 7)])
def test_batch_at_is_the_reference_bit_for_bit(vocab, batch, seq, seed):
    ours = TokenStream(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
    ref = JTokenStream(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
    for step in (0, 1, 7, 1000, 2**31 + 5):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_tensor_batch_at_on_a_device():
    s = TokenStream(vocab=300, batch=3, seq_len=9, seed=5)
    t = s.tensor_batch_at(4, "cpu")
    assert t.dtype == torch.int64 and t.device.type == "cpu" and tuple(t.shape) == (3, 10)
    np.testing.assert_array_equal(t.numpy(), s.batch_at(4))


def test_tensor_batch_at_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenStream(vocab=10, batch=1, seq_len=2).tensor_batch_at(0)


def test_stream_deterministic_and_seekable_port():
    s1 = TokenStream(vocab=1000, batch=4, seq_len=16, seed=42)
    s2 = TokenStream(vocab=1000, batch=4, seq_len=16, seed=42)
    np.testing.assert_array_equal(s1.batch_at(7), s2.batch_at(7))
    assert not np.array_equal(s1.batch_at(7), s1.batch_at(8))
    b = s1.batch_at(3)
    assert b.shape == (4, 17) and b.dtype == np.int32
    assert b.min() >= 0 and b.max() < 1000


def test_stream_seed_isolation_port():
    a = TokenStream(vocab=100, batch=2, seq_len=8, seed=1).batch_at(0)
    b = TokenStream(vocab=100, batch=2, seq_len=8, seed=2).batch_at(0)
    assert not np.array_equal(a, b)


def test_lingam_batches_tile_port():
    x = np.arange(64, dtype=np.float64).reshape(8, 8)
    grid = lingam_batches(x, 2, 4)
    assert len(grid) == 2 and len(grid[0]) == 4
    np.testing.assert_array_equal(np.block(grid), x)
    for got, want in zip(grid, j_lingam_batches(x, 2, 4)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="does not split"):
        lingam_batches(x, 3, 4)

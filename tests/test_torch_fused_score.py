"""The fused triangular score kernel's plain versions held against the JAX
package's Pallas kernels (interpret mode) and its jnp oracle, on the cases of
``tests/test_fused_score.py``: odd p, several sample chunk widths, dead rows
holding NaN, masks and ``n_valid`` padding; and the batched entry
(``fused_score_batch``) on ragged buckets with one valid count per dataset,
against ``repro.kernels.fused_score.fused_score_batch``. The wrappers' input
checks run here too; the kernel itself runs only on the card
(``test_torch_cuda.py``).

Tolerance: a live score may differ by 1e-3 of the largest score of its
case. Both sides take the same float32 formulas and differ only in the order
of the sample and tile sums. Each stat I_ij (~1e-3 on this Gaussian data) is
a difference of entropies near 1.42 whose float32 rounding (~1e-7) is ~1e-4
of I, so S = sum min(0, I)^2 (1e-7..1e-5 here) carries ~2e-4 of its scale:
the largest difference measured on these cases is 2.9e-4 of the largest
score. A fixed atol would exceed the scores themselves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.covariance import cov_matrix, normalize  # noqa: E402
from repro.core.pairwise import fused_scores as j_fused_scores  # noqa: E402
from repro.kernels.fused_score import fused_score_batch as j_batch_kernel  # noqa: E402
from repro.kernels.fused_score import fused_score_vector as j_kernel  # noqa: E402
from repro_torch.core.pairwise import fused_layout as t_layout  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: Largest score difference allowed, as a share of the case's largest score.
SCORE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(p, n, seed=0):
    rng = np.random.default_rng(seed)
    xn = jax.jit(normalize)(jnp.asarray(rng.standard_normal((p, n)), jnp.float32))
    c = jax.jit(cov_matrix)(xn)
    return np.array(xn), np.array(c), np.ones((p,), bool)


def _port(xn, c, mask, **kw):
    return fs.fused_score_vector(torch.from_numpy(xn), torch.from_numpy(c),
                                 torch.from_numpy(mask), **kw).numpy()


def _close(a, b, sel=slice(None)):
    """Equal +inf pattern; finite scores within SCORE_SHARE of the largest."""
    a, b = np.asarray(a, np.float64)[sel], np.asarray(b, np.float64)[sel]
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    live = np.isfinite(b)
    scale = np.abs(b[live]).max()
    assert scale > 0, "every reference score is zero: the comparison is empty"
    np.testing.assert_allclose(a[live], b[live], rtol=0, atol=SCORE_SHARE * scale)


@pytest.mark.parametrize("p,n", [(8, 512), (20, 600), (33, 700), (7, 130)])
def test_plain_matches_pallas_kernel(p, n):
    """Odd p, n not a multiple of the 512-sample chunk."""
    xn, c, mask = _setup(p, n, seed=p * 1000 + n)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=8, block_n=512, interpret=True)
    _close(_port(xn, c, mask), s_k)


@pytest.mark.parametrize("block,block_n", [(8, 128), (8, 256), (16, 512)])
def test_plain_matches_pallas_block_shapes(block, block_n):
    """The Pallas kernel's sample chunk width changes only its sum order;
    the port's chunk width is fixed (``fused_score.BLOCK_N``)."""
    xn, c, mask = _setup(24, 640, seed=3)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=block, block_n=block_n, interpret=True)
    _close(_port(xn, c, mask, block=block), s_k)


@pytest.mark.parametrize("p,n,block", [(8, 512, 8), (33, 700, 16), (17, 300, 32)])
def test_plain_matches_jnp_oracle(p, n, block):
    xn, c, mask = _setup(p, n, seed=p + block)
    s_o = j_fused_scores(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                         block=block)
    _close(_port(xn, c, mask, block=block), s_o)


def _dead_row_case():
    p, n = 16, 700
    xn, c, _ = _setup(p, n, seed=11)
    xn[3, :] = np.nan
    c[3, :] = np.nan
    c[:, 3] = np.nan
    mask = np.ones((p,), bool)
    mask[3] = False
    return xn, c, mask


def test_dead_row_nonfinite_data():
    """Dead rows may hold NaN; the select keeps it out of live scores."""
    xn, c, mask = _dead_row_case()
    s_t = _port(xn, c, mask)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=8, interpret=True)
    s_o = j_fused_scores(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask), block=8)
    assert np.all(np.isfinite(s_t[mask])) and s_t[3] == np.inf
    _close(s_t, s_k, mask)
    _close(s_t, s_o, mask)


def test_respects_mask():
    p, n = 16, 700
    xn, c, _ = _setup(p, n, seed=11)
    mask = np.arange(p) % 3 != 0
    s_t = _port(xn, c, mask)
    s_k = j_kernel(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                   block=8, interpret=True)
    assert np.all(s_t[~mask] == np.inf)
    _close(s_t, s_k)


def test_n_valid_padding():
    """Zero-padded sample columns change nothing but the denominator."""
    p, n, n_pad = 20, 500, 640
    xn, c, mask = _setup(p, n, seed=5)
    xp = np.zeros((p, n_pad), np.float32)
    xp[:, :n] = xn
    s_exact = _port(xn, c, mask)
    s_pad = _port(xp, c, mask, n_valid=torch.tensor(n))
    _close(s_pad, s_exact)
    s_k = j_kernel(jnp.asarray(xp), jnp.asarray(c), jnp.asarray(mask), block=8,
                   block_n=128, interpret=True, n_valid=jnp.asarray(n))
    _close(s_pad, s_k)


def test_wrapper_checks_inputs():
    xn, c, mask = (torch.from_numpy(a) for a in _setup(9, 64, seed=1))
    with pytest.raises(TypeError):
        fs.fused_score_vector(xn.double(), c, mask)
    with pytest.raises(TypeError):
        fs.fused_score_vector(xn, c, mask.float())
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn, c[:8, :8], mask)
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn.T.contiguous().T, c, mask)
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn, c, mask, block=33)
    with pytest.raises(ValueError):
        fs.fused_score_vector(xn.to("meta"), c.to("meta"), mask.to("meta"))


def test_cpu_route_runs_plain_version_uncounted():
    xn, c, mask = (torch.from_numpy(a) for a in _setup(12, 200, seed=2))
    before = fs.LAUNCHES
    s = ops.score_vector(xn, c, mask)
    assert fs.LAUNCHES == before
    assert torch.equal(s, fs.fused_score_vector_ref(xn, c, mask))


@pytest.mark.parametrize("b,tiles", [(8, 1), (8, 120), (8, 2016), (16, 6), (32, 3),
                                     (7, 10), (2, 1)])
def test_lanes_fit_one_thread_block(b, tiles):
    lanes = fs._lanes(b, tiles)
    threads = b * b * lanes
    assert 2 * b <= threads <= 1024


def _ragged_bucket(shapes, n_pad, seed):
    """Ragged normalized datasets zero-padded into one bucket (JAX side), with
    dead rows holding NaN in xn and c and one valid count per dataset."""
    rng = np.random.default_rng(seed)
    p_pad = max(p for p, _ in shapes)
    xs = np.zeros((len(shapes), p_pad, n_pad), np.float32)
    cs = np.full((len(shapes), p_pad, p_pad), np.nan, np.float32)
    mask = np.zeros((len(shapes), p_pad), bool)
    for i, (p, n) in enumerate(shapes):
        xn = np.array(jax.jit(normalize)(jnp.asarray(rng.standard_normal((p, n)), jnp.float32)))
        xs[i, :p, :n] = xn
        xs[i, p:] = np.nan
        cs[i, :p, :p] = np.array(jax.jit(cov_matrix)(jnp.asarray(xn)))
        mask[i, :p] = True
    return xs, cs, mask, np.array([n for _, n in shapes], np.int32)


def test_batch_plain_matches_pallas_batch_kernel():
    """Ragged p and n in one bucket, NaN dead rows, per-dataset valid counts;
    each dataset's scores within SCORE_SHARE of its largest score."""
    xs, cs, mask, nv = _ragged_bucket([(20, 600), (13, 450), (17, 512)], 640, 21)
    s_t = fs.fused_score_batch(torch.from_numpy(xs), torch.from_numpy(cs),
                               torch.from_numpy(mask), n_valid=torch.from_numpy(nv)).numpy()
    s_k = j_batch_kernel(jnp.asarray(xs), jnp.asarray(cs), jnp.asarray(mask), block=8,
                         block_n=128, interpret=True, n_valid=jnp.asarray(nv))
    for i in range(xs.shape[0]):
        assert np.all(np.isinf(s_t[i][~mask[i]]))
        _close(s_t[i], np.asarray(s_k[i]), mask[i])


def test_batch_plain_is_vector_plain_row_for_row():
    xs, cs, mask, nv = _ragged_bucket([(9, 300), (16, 280), (12, 320)], 320, 4)
    xs_t, cs_t, mask_t = (torch.from_numpy(a) for a in (xs, cs, mask))
    nv_t = torch.from_numpy(nv)
    s = fs.fused_score_batch_ref(xs_t, cs_t, mask_t, n_valid=nv_t)
    for i in range(xs.shape[0]):
        assert torch.equal(s[i], fs.fused_score_vector_ref(xs_t[i], cs_t[i], mask_t[i],
                                                           n_valid=nv_t[i]))


def test_batch_prologue_equals_per_dataset_prologue():
    """The batched ``fused_layout`` the card's wrapper runs (diagonal tiles
    and row entropies of the whole bucket at once, one valid count per
    dataset) is bit-identical to the one-dataset prologue, row for row."""
    xs, cs, mask, nv = _ragged_bucket([(21, 600), (10, 500), (16, 640)], 640, 9)
    xs_t, cs_t, mask_t = (torch.from_numpy(a) for a in (xs, cs, mask))
    nv_t = torch.from_numpy(nv)
    batched = t_layout(xs_t, cs_t, mask_t, 8, n_valid=nv_t)
    for i in range(xs.shape[0]):
        for one, many in zip(t_layout(xs_t[i], cs_t[i], mask_t[i], 8, n_valid=nv_t[i]),
                             batched):
            torch.testing.assert_close(many[i], one, rtol=0, atol=0, equal_nan=True)


def test_batch_wrapper_checks_inputs():
    xs, cs, mask, _ = (torch.from_numpy(a) for a in _ragged_bucket([(9, 64), (9, 64)], 64, 1))
    with pytest.raises(ValueError, match="B, p, n"):
        fs.fused_score_batch(xs[0], cs[0], mask[0])
    with pytest.raises(ValueError):
        fs.fused_score_batch(xs, cs[:, :8, :8], mask)
    with pytest.raises(ValueError):
        fs.fused_score_batch(xs, cs, mask[:1])
    with pytest.raises(TypeError):
        fs.fused_score_batch(xs.double(), cs, mask)
    with pytest.raises(ValueError):
        fs.fused_score_batch(xs.to("meta"), cs.to("meta"), mask.to("meta"))


def test_batch_cpu_route_runs_plain_version_uncounted():
    xs, cs, mask, nv = (torch.from_numpy(a) for a in _ragged_bucket([(12, 200), (7, 150)], 200, 2))
    before = fs.BATCH_LAUNCHES
    s = ops.score_batch(xs, cs, mask, n_valid=nv)
    assert fs.BATCH_LAUNCHES == before
    assert torch.equal(s, fs.fused_score_batch_ref(xs, cs, mask, n_valid=nv))

"""The port's CUDA kernels against their plain torch versions, on the card:
the fused triangular score kernel through both entries, one dataset
(``fused_score_vector``) and a bucket of datasets (``fused_score_batch``);
the square moments kernel through ``pairwise_moments`` and
``pairwise_moments_batch``, with and without live-row masks and valid
counts; the rank-1 update kernel in its TPU mode (``update_data``,
``update_cov``) and its fit mode (``rank1_update``, and the orders of the
fits that run it); the SSD decode kernel (``ssd_decode``); one threshold
``fit`` against the dense order; one ``Engine.generate`` of a
full-width Mamba2 mixer against the CPU route; and MoE and MLA
(``models/moe.py``, ``mla_block``; torch ops, no hand kernel) on the card
against the CPU on the same inputs, the MoE combine bit-equal from call to
call; whisper's ``Engine.generate(enc=)`` against the CPU, ``launch.train``
on the card (whisper-base at full width, granite-3-2b at ``--preset
100m``), and the trainer's step in place on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor ``repro``, so it runs on a
machine with only torch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the rank-1 update and decode kernels against their plain
versions at rtol 1e-5 and atol 1e-5 (1e-6 on the covariance), as
``tests/test_kernels.py`` holds the Pallas kernels, and bit-equal where both
round each step alike: the update kernel's TPU mode, and its fit mode, whose
sum of squares replays torch.sum's order on the card (its scale within
``covupdate.SCALE_ULP_TOL`` = 0 ulp); ``fused_score.score_tolerance`` — float32 rounding of each
entropy carried through I and S = sum min(0, I)^2. The kernel and the plain
version take the same float32 formulas and differ only in the order of the
sums. The square kernel's raw sums are held to
``pairwise_score.sum_tolerance`` (64 ulps of sum_k (|u| + 1) per entry) off
the diagonal, whose sums are amplified rounding noise in every
implementation (see ``kernels/pairwise_score.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import paralingam as tp  # noqa: E402
from repro_torch.core import sem  # noqa: E402
from repro_torch.core.covariance import cov_matrix, normalize  # noqa: E402
from repro_torch import configs, measure  # noqa: E402
from repro_torch.kernels import covupdate as cu  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pairwise_score as ps  # noqa: E402
from repro_torch.kernels import ssd_decode as sd  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(p, n, seed, device):
    x = np.random.default_rng(seed).standard_normal((p, n)).astype(np.float32)
    xn = normalize(torch.from_numpy(x).to(device))
    return xn, cov_matrix(xn)


@pytest.mark.parametrize("p,n,block", [(37, 1300, 8), (85, 2000, 8), (24, 640, 16),
                                       (7, 130, 8), (70, 900, 32)])
def test_kernel_matches_plain(cuda, p, n, block):
    """Odd p, ragged n, and dead rows holding NaN."""
    xn, c = _setup(p, n, p, cuda)
    mask = torch.arange(p, device=cuda) % 5 != 0
    xn = torch.where(mask[:, None], xn, torch.nan)
    c = torch.where(mask[:, None] & mask[None, :], c, torch.nan)
    before = fs.LAUNCHES
    s_k = fs.fused_score_vector(xn, c, mask, block=block)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    s_r = fs.fused_score_vector_ref(xn, c, mask, block=block)
    assert torch.all(torch.isinf(s_k[~mask]))
    tol = fs.score_tolerance(s_r, xn, c, mask)
    assert torch.all((s_k - s_r)[mask].abs() <= tol[mask])


def test_kernel_n_valid_padding(cuda):
    """Zero-padded sample columns with ``n_valid`` give the bits of the
    unpadded launch: the kernels stop at the valid count, and the chunk
    boundaries and lane stride depend on neither n nor B. n=700 rows are
    16-byte aligned, n=1901 rows are not (4-byte staging)."""
    for p, n, n_pad in ((21, 700, 1024), (19, 1901, 2048)):
        xn, c = _setup(p, n, 9, cuda)
        xp = torch.zeros((p, n_pad), device=cuda)
        xp[:, :n] = xn
        mask = torch.arange(p, device=cuda) % 7 != 3
        s_exact = fs.fused_score_vector(xn, c, mask)
        s_pad = fs.fused_score_vector(xp, c, mask, n_valid=torch.tensor(n, device=cuda))
        assert torch.equal(s_pad, s_exact)
        assert torch.all(torch.isinf(s_exact[~mask]))
        assert torch.all(torch.isfinite(s_exact[mask]))


def test_kernel_is_deterministic(cuda):
    xn, c = _setup(256, 1000, 3, cuda)
    mask = torch.ones(256, dtype=torch.bool, device=cuda)
    first = fs.fused_score_vector(xn, c, mask)
    for _ in range(3):
        assert torch.equal(fs.fused_score_vector(xn, c, mask), first)


def _bucket(shapes, n_pad, seed, device):
    """Ragged Gaussian datasets zero-padded into one bucket and normalized
    with their valid counts; dead rows hold NaN in xn and c."""
    p_pad = max(p for p, _ in shapes)
    rng = np.random.default_rng(seed)
    x = torch.zeros((len(shapes), p_pad, n_pad), device=device)
    mask = torch.zeros((len(shapes), p_pad), dtype=torch.bool, device=device)
    for i, (p, n) in enumerate(shapes):
        x[i, :p, :n] = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32))
        mask[i, :p] = True
    nv = torch.tensor([n for _, n in shapes], dtype=torch.int32, device=device)
    xn = torch.where(mask[..., None], normalize(x, n_valid=nv), 0.0)
    c = cov_matrix(xn, n_valid=nv)
    xn = torch.where(mask[..., None], xn, torch.nan).contiguous()
    c = torch.where(mask[:, :, None] & mask[:, None, :], c, torch.nan).contiguous()
    return xn, c, mask, nv


def test_batch_kernel_matches_plain(cuda):
    """Ragged p and n in one bucket, per-dataset valid counts, NaN dead rows."""
    xb, cb, mb, nv = _bucket([(37, 1300), (29, 900), (40, 1500), (8, 700)], 1536, 5, cuda)
    before = fs.BATCH_LAUNCHES
    s_k = fs.fused_score_batch(xb, cb, mb, n_valid=nv)
    torch.cuda.synchronize()
    assert fs.BATCH_LAUNCHES == before + 1
    s_r = fs.fused_score_batch_ref(xb, cb, mb, n_valid=nv)
    assert torch.all(torch.isinf(s_k[~mb]))
    for i in range(xb.shape[0]):
        tol = fs.score_tolerance(s_r[i], xb[i], cb[i], mb[i], n_valid=nv[i])
        assert torch.all((s_k[i] - s_r[i])[mb[i]].abs() <= tol[mb[i]])
        assert int(torch.argmin(s_k[i])) == int(torch.argmin(s_r[i]))


def test_batch_row_is_batch_size_invariant(cuda):
    """Row i of a batched launch is bit-identical to a launch of dataset i
    alone on the same inputs, whatever the batch size."""
    xb, cb, mb, nv = _bucket([(24, 640)] * 6, 640, 7, cuda)
    full = fs.launch_batch(xb, cb, mb, nv)
    half = fs.launch_batch(xb[:3].contiguous(), cb[:3].contiguous(), mb[:3].contiguous(),
                           nv[:3].contiguous())
    assert torch.equal(full[:3], half)
    for i in range(xb.shape[0]):
        one = fs.launch(xb[i], cb[i], mb[i], nv[i:i + 1])
        assert torch.equal(full[i], one)


def test_batch_row_equals_vector_wrapper(cuda):
    """With the prologue folded into the kernels, row i of
    ``fused_score_batch`` on a ragged bucket is bit-identical to
    ``fused_score_vector`` on dataset i with its valid count, and to the
    vector wrapper on dataset i cut to its live rows and valid samples (the
    cut has fewer row blocks, but the same lane count at these sizes)."""
    shapes = [(37, 1300), (29, 901), (40, 1536), (8, 700)]
    xb, cb, mb, nv = _bucket(shapes, 1536, 13, cuda)
    s_b = fs.fused_score_batch(xb, cb, mb, n_valid=nv)
    for i, (p, n) in enumerate(shapes):
        nt, nt_cut = 5, -(-p // 8)
        assert fs._lanes(8, nt * (nt - 1) // 2) == fs._lanes(8, nt_cut * (nt_cut - 1) // 2)
        s_v = fs.fused_score_vector(xb[i], cb[i], mb[i], n_valid=nv[i])
        assert torch.equal(s_b[i], s_v)
        cut = fs.fused_score_vector(xb[i, :p, :n].contiguous(), cb[i, :p, :p].contiguous(),
                                    mb[i, :p].contiguous())
        assert torch.equal(s_b[i, :p], cut)


def test_dead_launch_returns_inf_and_stages_nothing(cuda):
    """A launch whose datasets are all dead returns +inf everywhere, and
    every tile returns before it stages a sample: NaN data, NaN
    correlations and a valid count past the buffer are never read."""
    xb = torch.full((3, 40, 1024), torch.nan, device=cuda)
    cb = torch.full((3, 40, 40), torch.nan, device=cuda)
    mb = torch.zeros((3, 40), dtype=torch.bool, device=cuda)
    assert int(measure.live_tiles(mb, 8).sum()) == 0
    assert measure.sweep_chunks(mb, None, 1024, 8)[0] == 0
    s = fs.fused_score_batch(xb, cb, mb, n_valid=torch.full((3,), 4096, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(s, torch.full_like(s, torch.inf))
    # One live row per dataset: no live pair, so no tile sweeps; its score is 0.
    mb[:, 5] = True
    xb[:, 5] = 0.0
    s = fs.fused_score_batch(xb, cb, mb)
    assert torch.equal(s[:, 5], torch.zeros(3, device=cuda))
    assert torch.all(torch.isinf(s[~mb]))


def test_batch_kernel_is_deterministic(cuda):
    xb, cb, mb, nv = _bucket([(128, 2048), (100, 1900)], 2048, 11, cuda)
    first = fs.fused_score_batch(xb, cb, mb, n_valid=nv)
    for _ in range(3):
        assert torch.equal(fs.fused_score_batch(xb, cb, mb, n_valid=nv), first)


def _off_diagonal(t):
    """Entries (i, j) with i != j: the (i, i) sums of a row against itself
    are amplified rounding noise."""
    pi, pj = t.shape[-2:]
    keep = torch.arange(pi, device=t.device)[:, None] != torch.arange(pj, device=t.device)
    return t[..., keep]


@pytest.mark.parametrize("pi,pj,n", [(13, 13, 700), (128, 128, 2000), (37, 21, 1300)])
def test_square_kernel_matches_plain(cuda, pi, pj, n):
    """Ragged rows and samples, a non-square block, off-diagonal sums within
    ``sum_tolerance``."""
    xi, c = _setup(pi, n, pi, cuda)
    xj = xi[:pj].contiguous()
    c = c[:, :pj].contiguous()
    before = ps.LAUNCHES
    m1, m2 = ps.pairwise_moments(xi, xj, c)
    torch.cuda.synchronize()
    assert ps.LAUNCHES == before + 1
    r1, r2 = ps.pairwise_moments_ref(xi, xj, c)
    tol = ps.sum_tolerance(xi, xj, c)
    for k, r in ((m1, r1), (m2, r2)):
        assert torch.all(torch.isfinite(k))
        assert torch.all(_off_diagonal((k - r).abs()) <= _off_diagonal(tol))


def test_square_kernel_zero_padding_is_exact(cuda):
    """Zero sample columns add exactly 0: the sums are bit-identical."""
    xn, c = _setup(9, 300, 3, cuda)
    for n_pad in (512, 1600):
        xp = torch.zeros((9, n_pad), device=cuda)
        xp[:, :300] = xn
        for a, b in zip(ps.pairwise_moments(xn, xn, c), ps.pairwise_moments(xp, xp, c)):
            assert torch.equal(a, b)


def test_square_batch_row_is_batch_size_invariant(cuda):
    """Row b of a batched launch is bit-identical to a one-dataset launch of
    dataset b, and repeated launches agree."""
    xb, cb, _, _ = _bucket([(40, 900)] * 5, 900, 13, cuda)
    before = ps.BATCH_LAUNCHES
    m1, m2 = ps.pairwise_moments_batch(xb, cb)
    assert ps.BATCH_LAUNCHES == before + 1
    for b in range(xb.shape[0]):
        o1, o2 = ps.pairwise_moments(xb[b], xb[b], cb[b])
        assert torch.equal(m1[b], o1) and torch.equal(m2[b], o2)
    again = ps.pairwise_moments_batch(xb, cb)
    assert torch.equal(again[0], m1) and torch.equal(again[1], m2)


def _masked(p, n, n_pad, seed, device, fill=0.0):
    """Gaussian rows with every fifth row dead, held at 0 in xn and c as the
    pipeline holds them, padded to ``n_pad`` samples with ``fill``: (rows,
    padded rows, c, mask)."""
    xn, c = _setup(p, n, seed, device)
    mask = torch.arange(p, device=device) % 5 != 2
    xn = torch.where(mask[:, None], xn, 0.0).contiguous()
    c = torch.where(mask[:, None] & mask[None, :], c, 0.0).contiguous()
    xp = torch.full((p, n_pad), fill, device=device)
    xp[:, :n] = xn
    return xn, xp, c, mask


@pytest.mark.parametrize("p,pj,n,n_pad", [(37, 37, 1300, 2048), (21, 21, 700, 1024),
                                          (37, 21, 1901, 2048)])
def test_square_kernel_masked_n_valid_matches_plain(cuda, p, pj, n, n_pad):
    """Live-row masks and a valid count, as the pipeline passes them: live
    off-diagonal sums within ``sum_tolerance``, every pair with a dead row
    exactly 0."""
    _, xp, c, mask = _masked(p, n, n_pad, p + n, cuda)
    xj, cj, mj = xp[:pj].contiguous(), c[:, :pj].contiguous(), mask[:pj].contiguous()
    nv = torch.tensor(n, device=cuda)
    kw = {"live_i": mask, "live_j": mj, "n_valid": nv}
    m1, m2 = ps.pairwise_moments(xp, xj, cj, **kw)
    r1, r2 = ps.pairwise_moments_ref(xp, xj, cj, **kw)
    live = mask[:, None] & mj[None, :]
    sel = live & (torch.arange(p, device=cuda)[:, None] != torch.arange(pj, device=cuda))
    tol = ps.sum_tolerance(xp, xj, cj, nv)
    for k, r in ((m1, r1), (m2, r2)):
        assert torch.all(k[~live] == 0)
        assert torch.all(torch.isfinite(k[sel]))
        assert torch.all((k - r)[sel].abs() <= tol[sel])


@pytest.mark.parametrize("fill", [0.0, float("nan")])
def test_square_kernel_n_valid_padding_is_bit_exact(cuda, fill):
    """A padded launch with ``n_valid`` gives the unpadded launch's bits,
    whatever the padding holds: the loops stop at the valid count (n=700
    rows 16-byte aligned, n=1901 not)."""
    for p, n, n_pad in ((21, 700, 1024), (19, 1901, 2048)):
        xn, xp, c, mask = _masked(p, n, n_pad, n, cuda, fill)
        kw = {"live_i": mask, "live_j": mask}
        padded = ps.pairwise_moments(xp, xp, c, n_valid=torch.tensor(n, device=cuda), **kw)
        for a, b in zip(padded, ps.pairwise_moments(xn, xn, c, **kw)):
            assert torch.equal(a, b)


def test_square_batch_rows_under_masks(cuda):
    """Under masks and valid counts, row b of a batched launch is
    bit-identical to a one-dataset launch of dataset b, dead pairs are 0,
    and live off-diagonal sums are within ``sum_tolerance`` of plain."""
    xb, cb, mb, nv = _bucket([(37, 1300), (29, 900), (40, 1536), (8, 700)], 1536, 17, cuda)
    xb = torch.where(mb[..., None], xb, 0.0).contiguous()
    cb = torch.where(mb[:, :, None] & mb[:, None, :], cb, 0.0).contiguous()
    before = ps.BATCH_LAUNCHES
    m1, m2 = ps.pairwise_moments_batch(xb, cb, mask=mb, n_valid=nv)
    assert ps.BATCH_LAUNCHES == before + 1
    r1, r2 = ps.pairwise_moments_batch_ref(xb, cb, mask=mb, n_valid=nv)
    for b in range(xb.shape[0]):
        o1, o2 = ps.pairwise_moments(xb[b], xb[b], cb[b], live_i=mb[b], live_j=mb[b],
                                     n_valid=nv[b])
        assert torch.equal(m1[b], o1) and torch.equal(m2[b], o2)
        live = mb[b][:, None] & mb[b][None, :]
        sel = live & ~torch.eye(live.shape[0], dtype=torch.bool, device=cuda)
        tol = ps.sum_tolerance(xb[b], xb[b], cb[b], nv[b])
        for k, r in ((m1[b], r1[b]), (m2[b], r2[b])):
            assert torch.all(k[~live] == 0)
            assert torch.all((k - r)[sel].abs() <= tol[sel])


def test_threshold_fit_matches_dense_order(cuda):
    """The threshold state machine returns the dense evaluation's root at
    every iteration (paper Section 3.2), on the card, through both order
    drivers; the square kernel's fit gives the same order."""
    x = sem.generate(sem.SemSpec(p=24, n=3000, density="sparse", seed=5))["x"]
    dense, _ = tp.fit(x, tp.ParaLiNGAMConfig(min_bucket=8), device=cuda)
    square, _ = tp.fit(x, tp.ParaLiNGAMConfig(min_bucket=8, score_backend="hopper"),
                       device=cuda)
    thr, _ = tp.fit(x, tp.ParaLiNGAMConfig(min_bucket=8, threshold=True), device=cuda)
    host = tp.causal_order(x, tp.ParaLiNGAMConfig(min_bucket=8, threshold=True),
                           device=cuda)
    assert square.order == dense.order
    assert thr.order == dense.order and host.order == dense.order
    assert thr.converged and 0 < thr.comparisons <= thr.comparisons_dense


def test_fit_batch_rows_do_not_depend_on_the_batch(cuda):
    """Each dataset's order, threshold counters, B and noise variances in a
    padded bucket equal, bit for bit, those of its own one-dataset
    ``fit_batch`` on the same padded inputs (the correlations are one GEMM
    per dataset: a batched GEMM rounds by batch count)."""
    rng = np.random.default_rng(21)
    shapes = [(24, 2000), (20, 1500), (22, 1800), (17, 2000)]
    xs = np.zeros((4, 24, 2048), np.float32)
    mask = np.zeros((4, 24), bool)
    for i, (p, n) in enumerate(shapes):
        xs[i, :p, :n] = sem.generate(sem.SemSpec(p=p, n=n, density="sparse",
                                                 seed=int(rng.integers(1000))))["x"]
        mask[i, :p] = True
    nv = np.array([n for _, n in shapes], np.int32)
    for cfg in (tp.ParaLiNGAMConfig(min_bucket=8),
                tp.ParaLiNGAMConfig(min_bucket=8, threshold=True)):
        res = tp.fit_batch(xs, cfg, n_valid=nv, mask=mask, device=cuda)
        for i in range(4):
            one = tp.fit_batch(xs[i:i + 1], cfg, n_valid=nv[i:i + 1], mask=mask[i:i + 1],
                               device=cuda)
            for name in ("orders", "comparisons", "rounds", "converged", "b", "noise_var"):
                assert torch.equal(getattr(res, name)[i], getattr(one, name)[0]), (name, i)


RTOL = ATOL = 1e-5
COV_ATOL = 1e-6


def _close(k, r, atol=ATOL):
    return bool(torch.all((k.double() - r.double()).abs() <= atol + RTOL * r.double().abs()))


@pytest.mark.parametrize("p,n", [(8, 512), (21, 1000), (64, 4096), (7, 130), (85, 10000)])
def test_covupdate_kernels_match_plain(cuda, p, n):
    xn, c = _setup(p, n, p, cuda)
    b = c[:, 0].clone()
    b[0] = 0.0
    xr = xn[0].contiguous()
    before = (cu.DATA_LAUNCHES, cu.COV_LAUNCHES)
    kx, kc = ops.update_data(xn, xr, b), ops.update_cov(c, b)
    torch.cuda.synchronize()
    assert (cu.DATA_LAUNCHES, cu.COV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert _close(kx, cu.update_data_ref(xn, xr, b))
    assert _close(kc, cu.update_cov_ref(c, b), COV_ATOL)
    assert torch.equal(torch.diagonal(kc), torch.ones(p, device=cuda))


@pytest.mark.parametrize("p,n", [(8, 512), (21, 1000), (64, 4096), (7, 130), (85, 10000),
                                 (512, 2000)])
def test_covupdate_tpu_mode_is_bit_equal(cuda, p, n):
    """The TPU-kernel mode (no clip, floor 1e-12, no renormalization) gives
    the plain versions' bits, on aligned rows and on views at a 4-byte
    offset (the scalar path)."""
    xn, c = _setup(p, n, p, cuda)
    b = c[:, 0].clone()
    b[0] = 0.0
    xr = xn[0].contiguous()
    assert torch.equal(ops.update_data(xn, xr, b), cu.update_data_ref(xn, xr, b))
    assert torch.equal(ops.update_cov(c, b), cu.update_cov_ref(c, b))
    xo = torch.empty(p * n + 1, device=cuda)[1:].view(p, n)
    xo.copy_(xn)
    co = torch.empty(p * p + 1, device=cuda)[1:].view(p, p)
    co.copy_(c)
    assert torch.equal(ops.update_data(xo, xr, b), cu.update_data_ref(xn, xr, b))
    assert torch.equal(ops.update_cov(co, b), cu.update_cov_ref(c, b))


def _rank1_bucket(shapes, m, n_pad, seed, device, retired=3):
    """A bucket as the scan holds it: dataset i's p_i rows normalized over
    its n_i valid samples (zeros past them), its correlations, ``retired``
    earlier roots dead but still holding data, and one live root each."""
    rng = np.random.default_rng(seed)
    x = torch.zeros((len(shapes), m, n_pad), device=device)
    mask = torch.zeros((len(shapes), m), dtype=torch.bool, device=device)
    for i, (p, n) in enumerate(shapes):
        x[i, :p, :n] = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32))
        mask[i, :p] = True
    nv = torch.tensor([n for _, n in shapes], dtype=torch.int32, device=device)
    xn = torch.where(mask[..., None], normalize(x, n_valid=nv), 0.0).contiguous()
    c = cov_matrix(xn, n_valid=nv).contiguous()
    roots = []
    for i, (p, _) in enumerate(shapes):
        rows = rng.permutation(p)
        mask[i, torch.from_numpy(rows[:retired]).to(device)] = False
        roots.append(int(rows[retired]))
    return xn, c, torch.tensor(roots, device=device), mask, nv


def _hold_rank1(xb, cb, roots, mloc, nv):
    """The fit mode against its plain version, out of place and in place:
    c' bit-equal, each live row's scale within SCALE_ULP_TOL and x'
    bit-equal (the sum of squares in torch.sum's order), columns
    past the valid count +0, dead rows unchanged, the caller's tensors
    unchanged out of place; one count per launch."""
    x0, c0 = xb.clone(), cb.clone()
    rx, rc = cu.rank1_update_ref(xb, cb, roots, mloc, n_valid=nv)
    before = cu.RANK1_LAUNCHES
    kx, kc = ops.rank1_update(xb, cb, roots, mloc, nv)
    torch.cuda.synchronize()
    assert cu.RANK1_LAUNCHES == before + 1
    assert torch.equal(xb, x0) and torch.equal(cb, c0)
    assert torch.equal(kc, rc)
    assert float(cu.scale_ulps(kx, rx, xb, cb, roots, mloc).max()) <= cu.SCALE_ULP_TOL
    assert torch.equal(kx, rx)
    n = xb.shape[2]
    cols = torch.arange(n, device=xb.device)
    past = cols >= (n if nv is None else nv[:, None, None])
    assert torch.all(kx.masked_select(past.expand_as(kx)) == 0)
    live = mloc & (torch.arange(xb.shape[1], device=xb.device) != roots[:, None])
    assert torch.equal(kx[~live], xb[~live])
    own = xb.clone()
    ix, ic = ops.rank1_update(own, cb, roots, mloc, nv, inplace=True)
    assert ix.data_ptr() == own.data_ptr() and torch.equal(ix, kx) and torch.equal(ic, kc)
    return kx, kc


@pytest.mark.parametrize("shapes,m,n_pad", [
    ([(30, 1000), (25, 777), (32, 513)], 32, 1024),  # 16-byte rows, ragged valid counts
    ([(37, 1301), (20, 1000)], 37, 1301),  # odd m and n: the scalar paths
    ([(85, 10_000)], 85, 10_000),  # the E. coli fit's first stage
    ([(512, 2000)], 512, 2000),  # the iJR904 slice
    ([(8, 13_001), (6, 12_500)], 8, 13_004),  # rows past the register tile
])
def test_rank1_update_matches_plain(cuda, shapes, m, n_pad):
    xb, cb, roots, mloc, nv = _rank1_bucket(shapes, m, n_pad, m + n_pad, cuda)
    _hold_rank1(xb, cb, roots, mloc, nv)
    if len(shapes) == 1 and shapes[0] == (m, n_pad):  # the fit's call: no valid counts
        _hold_rank1(xb, cb, roots, mloc, None)


def test_rank1_update_clip_and_floor(cuda):
    """|b| at and past 1: the clip to [-1, 1] and the 1e-4 floor of 1 - b^2
    fire, and the card gives the plain version's c' and scales."""
    xb, cb, roots, mloc, nv = _rank1_bucket([(16, 600), (12, 500)], 16, 600, 3, cuda, retired=1)
    for d in range(2):
        r = int(roots[d])
        rows = [i for i in range(16) if bool(mloc[d, i]) and i != r][:6]
        for i, v in zip(rows, (1.0000001, -1.0000001, 0.99999, -0.9999999, 1.0, -1.0)):
            cb[d, i, r] = v
    kx, kc = _hold_rank1(xb, cb, roots, mloc, nv)
    assert torch.all(kc.abs() <= 1)


def test_rank1_update_rows_do_not_depend_on_the_batch(cuda):
    """Dataset i of a batched launch gives the bits of its own launch, and
    a zero-padded launch with valid counts the bits of the unpadded one
    (torch.sum, whose order the kernel replays, takes both rows alike here:
    the same block shape for 64 rows and for 256, every n a multiple of 4
    below 8,161)."""
    shapes = [(60, 1900), (64, 2000), (41, 1024), (64, 1500)]
    xb, cb, roots, mloc, nv = _rank1_bucket(shapes, 64, 2048, 17, cuda)
    kx, kc = ops.rank1_update(xb, cb, roots, mloc, nv)
    for i, (_, n) in enumerate(shapes):
        sl = slice(i, i + 1)
        ox, oc = ops.rank1_update(xb[sl], cb[sl], roots[sl], mloc[sl], nv[sl])
        assert torch.equal(kx[i], ox[0]) and torch.equal(kc[i], oc[0])
        cut = xb[sl, :, :n].contiguous()
        ux, _ = ops.rank1_update(cut, cb[sl], roots[sl], mloc[sl], nv[sl])
        assert torch.equal(kx[i, :, :n], ux[0])


def test_rank1_scale_is_torch_rsqrt(cuda):
    """The kernel's scale function gives torch's CUDA rsqrt bits (after the
    1e-12 floor) on every float32 in [0.25, 4) and on random magnitudes."""
    lo, hi = np.float32(0.25).view(np.int32), np.float32(4.0).view(np.int32)
    var = torch.arange(int(lo), int(hi), device=cuda, dtype=torch.int32).view(torch.float32)
    rng = np.random.default_rng(0)
    wide = torch.from_numpy((10.0 ** rng.uniform(-14, 6, 1 << 20)).astype(np.float32)).to(cuda)
    for v in (var, wide, torch.tensor([0.0, 1e-13, 1e-12, 1e30], device=cuda)):
        want = torch.rsqrt(torch.clamp(v, min=1e-12))
        assert torch.equal(cu.scale_probe(v).view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows,n", [
    (1024, 16384), (128, 10_000), (512, 2000), (256, 16384), (74, 1301), (8, 3000),
    (3, 100), (2, 300_000), (40, 131_072)])
def test_rank1_sum_order_is_torch_sum(cuda, rows, n):
    """The fit mode's sum of squares replays torch.sum's order on the card:
    the same bits on row counts and lengths that take each of ATen's
    shapes (one block per row, a warp per row, unaligned rows, scalar
    loads, fewer than 16 rows, a row split across blocks)."""
    x = torch.from_numpy(np.random.default_rng(rows + n).standard_normal((rows, n))
                         .astype(np.float32)).to(cuda)
    got, _ = cu.sum_probe(x)
    assert torch.equal(got, torch.sum(torch.square(x), dim=-1))


def _hold_forced(xb, cb, roots, mloc, nv, **force):
    """A fit-mode launch forced onto a plan (``cluster``, ``rows``): x' and
    c' bit-equal to the plain version, out of place and in place."""
    rx, rc = cu.rank1_update_ref(xb, cb, roots, mloc, n_valid=nv)
    kx, kc = cu.launch_rank1(xb, cb, roots, mloc, nv, **force)
    own = xb.clone()
    ix, ic = cu.launch_rank1(own, cb, roots, mloc, nv, inplace=True, **force)
    torch.cuda.synchronize()
    assert torch.equal(kc, rc) and torch.equal(kx, rx)
    assert torch.equal(ix, kx) and torch.equal(ic, kc)


@pytest.mark.parametrize("shapes,m,n_pad,force", [
    ([(85, 10_000)], 128, 10_000, dict(cluster=1)),  # the p=85 fit's first stage
    ([(85, 10_000)], 128, 10_000, dict(cluster=2)),
    ([(85, 10_000)], 128, 10_000, dict(cluster=4)),
    ([(60, 9000), (64, 8500)], 64, 9216, dict(cluster=2)),  # valid counts end mid-run
    ([(60, 9000), (64, 8500)], 64, 9216, dict(cluster=4)),
    ([(30, 16_384), (20, 9001)], 32, 16_384, {}),  # the dispatch's rows, held whole
    ([(512, 2000)], 512, 2000, dict(rows=1)),  # the p=512 fit: warp rows
    ([(512, 2000)], 512, 2000, dict(rows=2)),
    ([(512, 2000)], 512, 2000, dict(rows=8)),
    ([(30, 1000), (25, 777), (32, 513)], 32, 1024, dict(rows=4)),  # ragged valid counts
    ([(21, 1000), (13, 998)], 21, 1000, dict(rows=8)),  # a partial last block
    ([(37, 1301), (20, 1000)], 37, 1301, {}),  # odd n: every shift, the scalar path
    ([(16, 140_000)], 16, 140_000, {}),  # torch sums a row over 18 blocks: read twice
    ([(8, 3000)], 8, 3000, {}),  # fewer than 16 rows: torch's bw is 64
])
def test_rank1_update_plans_are_bit_equal(cuda, shapes, m, n_pad, force):
    """Each path of the fit mode's data rows, at each cluster size and row
    count, gives the plain version's bits."""
    xb, cb, roots, mloc, nv = _rank1_bucket(shapes, m, n_pad, m + n_pad, cuda)
    _hold_forced(xb, cb, roots, mloc, nv, **force)
    if len(shapes) == 1 and shapes[0] == (m, n_pad):
        _hold_forced(xb, cb, roots, mloc, None, **force)


@pytest.mark.parametrize("force", [dict(cluster=2), dict(cluster=4), dict(rows=4)])
def test_rank1_update_dead_datasets_and_edge_roots(cuda, force):
    """A dead dataset costs nothing in place and is copied out of place;
    roots on the first and the last row of a multi-row block; under each
    path."""
    n = 9216 if "cluster" in force else 2000
    xb, cb, roots, mloc, nv = _rank1_bucket([(16, n), (16, n - 7), (16, n - 400)], 16, n, 5,
                                           cuda, retired=1)
    mloc[1] = False
    roots[0], roots[2] = 0, 3
    mloc[0, 0] = mloc[2, 3] = True
    _hold_forced(xb, cb, roots, mloc, nv, **force)


def test_rank1_update_refuses_a_plan_the_shape_cannot_take(cuda):
    xb, cb, roots, mloc, nv = _rank1_bucket([(512, 2000)], 512, 2000, 1, cuda)
    with pytest.raises(RuntimeError, match="rank1_update"):
        cu.launch_rank1(xb, cb, roots, mloc, nv, cluster=2)
    xb, cb, roots, mloc, nv = _rank1_bucket([(85, 10_000)], 128, 10_000, 1, cuda)
    with pytest.raises(RuntimeError, match="rank1_update"):
        cu.launch_rank1(xb, cb, roots, mloc, nv, rows=2)


@pytest.mark.parametrize("kind,batch,m,n", [
    (cu.MODE_FIT, 1, 128, 10_000), (cu.MODE_FIT, 1, 512, 2000), (cu.MODE_FIT, 8, 128, 16384),
    (cu.MODE_FIT, 8, 64, 16384), (cu.MODE_FIT, 8, 32, 16384), (cu.MODE_RING, 64, 128, 10_000),
    (cu.MODE_RING, 64, 128, 5000), (cu.MODE_FIT, 2, 37, 1301), (cu.MODE_FIT, 1, 40, 131_072),
    (cu.MODE_FIT, 1, 8, 3000), (cu.MODE_FIT, 1, 3, 100), (cu.MODE_FIT, 1, 1024, 16384)])
def test_kernel_plan_is_the_python_plan(cuda, kind, batch, m, n):
    """The kernel's own plan equals ``covupdate.update_plan`` on this card,
    chosen and forced."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    forced = [{}] + [dict(cluster=k) for k in (1, 2, 4)] + [dict(rows=r) for r in (2, 8)]
    for force in forced:
        try:
            want = cu.update_plan(kind, batch, m, n, sms=sms, **force)
        except ValueError:
            with pytest.raises(RuntimeError):
                cu.kernel_plan(kind, batch, m, n, vec=n % 4 == 0, **force)
            continue
        got = cu.kernel_plan(kind, batch, m, n, vec=n % 4 == 0, **force)
        flat = {**{f: int(v) for f, v in want["order"].items()},
                **{f: int(want[f]) for f in ("path", "k", "rows", "staged", "cap",
                                              "data_blocks", "blocks", "smem")}}
        assert got == flat, (force, got, flat)


def _ring_case(m_l, n_loc, shards, seed, device):
    """One row block's ring-mode arguments at E. coli-like sizes (m = 2 m_l
    columns, the root in the other block) and the other sample shards'
    sums of squares, as ``_update_shard`` hands them to the kernel."""
    from repro_torch.core.covariance import rank1_gates

    m, n = 2 * m_l, n_loc * shards
    xn, c = _setup(m, n, seed, device)
    root = m_l + 3
    mask = torch.ones(m, dtype=torch.bool, device=device)
    mask[5] = False
    live = mask[:m_l].clone()
    b, s_row = rank1_gates(c[:m_l, root].contiguous(), live)
    b_col, s_col = rank1_gates(c[:, root].contiguous(), mask & (torch.arange(m, device=device) != root))
    others = torch.zeros(m_l, device=device)
    for k in range(1, shards):
        cols = slice(k * n_loc, (k + 1) * n_loc)
        out = (xn[:m_l, cols] - b[:, None] * xn[root, cols][None, :]) / s_row[:, None]
        others = others + torch.sum(torch.square(out), dim=-1)
    args = (xn[:m_l, :n_loc].contiguous(), c[:m_l].contiguous(), xn[root, :n_loc].contiguous(),
            b, s_row, b_col, s_col, live)
    return args, n, others


@pytest.mark.parametrize("m_l,n_loc,shards,force", [
    (64, 10_000, 1, {}), (64, 10_000, 1, dict(cluster=1)), (64, 10_000, 1, dict(cluster=2)),
    (64, 5000, 2, {}), (64, 5000, 2, dict(rows=2)), (64, 2000, 2, dict(rows=8)),
    (64, 10_000, 2, dict(cluster=2)), (21, 1301, 2, {}), (64, 9216, 1, dict(cluster=4))])
def test_ring_update_phases_are_bit_equal(cuda, m_l, n_loc, shards, force):
    """Ring mode's three phases (fused where the samples are whole, sums
    then scale around the sums' reduction where they are sharded), at the
    E. coli (1, 2, 1) and (1, 2, 2) blocks and forced plans: x' and c'
    bit-equal to ``ring_update_ref``, out of place and in place."""
    args, n, others = _ring_case(m_l, n_loc, shards, m_l + n_loc, cuda)
    reduce = None if shards == 1 else (lambda sq: sq.add_(others))
    rx, rc = cu.ring_update_ref(*args, row0=0, n=n, reduce=reduce)
    x, c, rest = args[0], args[1], args[2:]
    sq = torch.empty(m_l, device=cuda)
    for inplace in (False, True):
        xi, ci = (x.clone(), c.clone()) if inplace else (x, c)
        xo, co = (xi, ci) if inplace else (torch.empty_like(x), torch.empty_like(c))
        if reduce is None:
            cu.launch_ring(xi, xo, ci, co, *rest, sq, cu.RING_FUSED, 0, n, **force)
        else:
            cu.launch_ring(xi, xi, ci, co, *rest, sq, cu.RING_SUMS, 0, n, **force)
            reduce(sq)
            cu.launch_ring(xi, xo, ci, co, *rest, sq, cu.RING_SCALE, 0, n, **force)
        torch.cuda.synchronize()
        assert torch.equal(xo, rx) and torch.equal(co, rc)
    before = cu.RING_LAUNCHES
    gx, gc = ops.ring_update(*args, row0=0, n=n, reduce=reduce)
    assert cu.RING_LAUNCHES == before + (1 if reduce is None else 2)
    assert torch.equal(gx, rx) and torch.equal(gc, rc)


def test_kernel_update_orders_equal_plain(cuda):
    """E. coli-size fits: the kernel backends (the update kernel on the
    path, one launch per iteration) give the plain path's orders through
    ``fit`` and ``fit_batch``."""
    x = sem.generate(sem.SemSpec(p=85, n=10_000, density="sparse", seed=0))["x"]
    tp.reset_dispatch_stats()
    before = cu.RANK1_LAUNCHES
    kern, _ = tp.fit(x, tp.ParaLiNGAMConfig(score_backend="hopper_fused"), device=cuda)
    assert cu.RANK1_LAUNCHES == before + 84
    assert tp.dispatch_stats_snapshot()["rank1_update"] == 84
    plain, _ = tp.fit(x, tp.ParaLiNGAMConfig(score_backend="torch_fused"), device=cuda)
    assert kern.order == plain.order
    rng = np.random.default_rng(13)
    shapes = [(int(rng.integers(70, 86)), int(rng.integers(8193, 10_001))) for _ in range(4)]
    xs = np.zeros((4, 128, 16384), np.float32)
    mask = np.zeros((4, 128), bool)
    for i, (p, n) in enumerate(shapes):
        xs[i, :p, :n] = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=100 + i))["x"]
        mask[i, :p] = True
    nv = np.array([n for _, n in shapes], np.int32)
    before = cu.RANK1_LAUNCHES
    kb = tp.fit_batch(xs, tp.ParaLiNGAMConfig(score_backend="hopper_fused"), n_valid=nv,
                      mask=mask, device=cuda)
    assert cu.RANK1_LAUNCHES == before + 127
    pb = tp.fit_batch(xs, tp.ParaLiNGAMConfig(score_backend="torch_fused"), n_valid=nv,
                      mask=mask, device=cuda)
    for i, (p, _) in enumerate(shapes):
        assert torch.equal(kb.orders[i, :p], pb.orders[i, :p])


def _ssd_args(b, h, p, n, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
              rng.uniform(0.01, 0.5, (b, h)), rng.standard_normal((b, n)),
              rng.standard_normal((b, n)), -rng.uniform(0.5, 2.0, (h,)),
              rng.standard_normal((h,))]
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("b,h,p,n", [(2, 16, 16, 16), (4, 32, 64, 128), (1, 8, 32, 64),
                                     (3, 12, 16, 32), (2, 5, 24, 40)])
def test_ssd_decode_kernel_matches_plain(cuda, b, h, p, n):
    """The CPU tests' cases and head counts that are not multiples of 8."""
    args = _ssd_args(b, h, p, n, cuda, seed=b * 100 + h)
    before = sd.LAUNCHES
    y, s = ops.ssd_decode(*args)
    torch.cuda.synchronize()
    assert sd.LAUNCHES == before + 1
    yr, sr = sd.ssd_decode_ref(*args)
    assert _close(y, yr) and _close(s, sr)


def test_ssd_decode_rows_do_not_depend_on_the_batch(cuda):
    """Row b of a launch is bit-identical to a one-row launch of row b, and
    the input state is left as it was."""
    args = _ssd_args(4, 32, 64, 128, cuda, seed=3)
    keep = args[0].clone()
    y, s = sd.ssd_decode(*args)
    assert torch.equal(args[0], keep)
    for b in range(4):
        y1, s1 = sd.ssd_decode(*[t[b:b + 1].contiguous() for t in args[:5]], *args[5:])
        assert torch.equal(y1[0], y[b]) and torch.equal(s1[0], s[b])


def _offset(t):
    """A copy of ``t`` whose data start 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("b,h,p,n", [(2, 5, 24, 37), (3, 3, 70, 130), (1, 2, 17, 4),
                                     (2, 4, 33, 129), (4, 2, 16, 36)])
def test_ssd_decode_ragged_shapes(cuda, b, h, p, n):
    """P not a multiple of the kernel's P-slice, N not a multiple of 4 (the
    scalar path) or of 128: the new state bit-equal to plain, y within
    tolerance; row b of a launch bit-identical to a one-row launch of its
    views (not 16-byte aligned when N is odd); inputs at a 4-byte offset
    (the scalar path) give the aligned launch's bits."""
    args = _ssd_args(b, h, p, n, cuda, seed=7 * n + p)
    y, s = sd.ssd_decode(*args)
    yr, sr = sd.ssd_decode_ref(*args)
    assert torch.equal(s, sr) and _close(y, yr)
    for i in range(b):
        y1, s1 = sd.ssd_decode(*[t[i:i + 1].contiguous() for t in args[:5]], *args[5:])
        assert torch.equal(y1[0], y[i]) and torch.equal(s1[0], s[i])
    yo, so = sd.ssd_decode(*[_offset(t) for t in args])
    assert torch.equal(yo, y) and torch.equal(so, s)


def test_engine_full_width_mixer_matches_cpu(cuda):
    """Greedy ``Engine.generate`` of a full-width Mamba2 mixer (1 layer,
    vocab 512) on the card equals the CPU route on the same weights, with
    one decode-kernel launch per layer and decode step."""
    cfg = configs.get("mamba2-370m").with_overrides(n_layers=1, vocab=512)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    cpu = {"embed": {k: v.cpu() for k, v in params["embed"].items()},
           "final_norm": params["final_norm"].cpu(),
           "groups": [{"pos0": {"ln1": g["pos0"]["ln1"].cpu(),
                                "ssm": {k: v.cpu() for k, v in g["pos0"]["ssm"].items()}}}
                      for g in params["groups"]]}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    before = sd.LAUNCHES
    got = Engine(params, cfg, ServeConfig(max_new_tokens=8), device=cuda).generate(prompts)
    assert sd.LAUNCHES == before + 8 * cfg.n_layers
    want = Engine(cpu, cfg, ServeConfig(max_new_tokens=8), device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, want)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.parametrize("arch,layers,launches_per_step", [("granite-3-2b", 1, 0),
                                                           ("gemma3-12b", 6, 0),
                                                           ("zamba2-2.7b", 6, 6)])
def test_engine_attention_families_match_cpu(cuda, arch, layers, launches_per_step):
    """Greedy ``Engine.generate`` at full width (granite 1 layer; gemma3 one
    group, 5 windowed layers + 1 global; zamba2 one group, 6 Mamba2 layers
    + the shared attention block; vocab 512) on the card equals the CPU
    route on the same weights; the attention paths launch no hand kernel,
    the SSM layers one decode kernel per layer and step."""
    cfg = configs.get(arch).with_overrides(n_layers=layers, vocab=512)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    before = sd.LAUNCHES
    got = Engine(params, cfg, ServeConfig(max_new_tokens=8), device=cuda).generate(prompts)
    assert sd.LAUNCHES == before + 8 * launches_per_step
    want = Engine(_to_cpu(params), cfg, ServeConfig(max_new_tokens=8),
                  device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, want)


# -- MoE and MLA: torch ops on the card against the CPU ------------------------------

# float32 on both sides, the CPU tests' tolerances; a routing near-tie is a
# token whose CPU k-th and (k+1)-th router probabilities lie within
# ROUTE_TOL (chip_smoke.py's rule), where the card may pick other experts.
MOE_RTOL, MOE_ATOL, ROUTE_TOL = 1e-4, 1e-5, 1e-5


def _moe_cfg(arch):
    """Full width (d_model, d_ff_expert, top_k, shared experts), 8 experts
    for deepseek and 4 for llama4, so that the CPU side stays small."""
    return configs.get(arch).with_overrides(n_experts=8 if arch.startswith("deepseek") else 4)


def _routing_flips(router, x2d, k):
    """Tokens routed to other experts on the card than on the CPU, each
    asserted to lie at a near-tie of the CPU's probabilities."""
    _, _, card = moe.route(router, x2d, k)
    probs, _, cpu = moe.route(router.cpu(), x2d.cpu(), k)
    diff = (card.sort(-1).values.cpu() != cpu.sort(-1).values).any(-1)
    top = probs.sort(-1, descending=True).values
    for t in torch.nonzero(diff).flatten().tolist():
        assert float(top[t, k - 1] - top[t, k]) <= ROUTE_TOL, t
    return int(diff.sum())


@pytest.mark.parametrize("arch,t", [("deepseek-v2-lite-16b", 4), ("deepseek-v2-lite-16b", 200),
                                    ("llama4-scout-17b-a16e", 4), ("llama4-scout-17b-a16e", 96)])
def test_moe_ffn_on_the_card_matches_cpu(cuda, arch, t):
    """``moe_ffn`` (out and aux) at a decode step's 4 tokens and at a
    prefill's, float32; two calls on the card bit-equal. deepseek at T·k =
    1200 with capacity factor 1.0 (cap 150) drops by capacity. These seeded
    inputs hold no routing near-tie (the CPU's smallest k-th to (k+1)-th gap
    is 3.9e-5 at T=200, ≥ 2.5e-3 elsewhere), so the card must route every
    token as the CPU does and every output is compared."""
    cfg = _moe_cfg(arch).with_overrides(capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32)
    x = torch.randn((1, t, cfg.d_model), generator=gen)
    probs, _, eids = moe.route(p["router"], x[0], cfg.top_k)
    top = probs.sort(-1, descending=True).values
    assert float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min()) > ROUTE_TOL
    if t * cfg.top_k > 256:
        load = torch.bincount(eids.flatten(), minlength=cfg.n_experts)
        assert int(load.max()) > moe.capacity(t, cfg)
    pc = {k: (v.to(cuda) if torch.is_tensor(v) else {n: w.to(cuda) for n, w in v.items()})
          for k, v in p.items()}
    out, aux = moe.moe_ffn(pc, x.to(cuda), cfg)
    again, _ = moe.moe_ffn(pc, x.to(cuda), cfg)
    assert torch.equal(out, again)
    want, want_aux = moe.moe_ffn(p, x, cfg)
    assert _routing_flips(p["router"].to(cuda), x[0].to(cuda), cfg.top_k) == 0
    torch.testing.assert_close(out.cpu(), want, rtol=MOE_RTOL, atol=MOE_ATOL)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=MOE_RTOL, atol=MOE_ATOL)


def test_moe_combine_is_deterministic_in_bfloat16(cuda):
    """deepseek's top-6 combine in bfloat16 at full width: ten calls on the
    same inputs give the same bits (the k contributions are summed in k
    order, with no atomics)."""
    cfg = _moe_cfg("deepseek-v2-lite-16b")
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = moe.init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn((4, 32, cfg.d_model), generator=gen, device=cuda).bfloat16()
    first, _ = moe.moe_ffn(p, x, cfg)
    for _ in range(9):
        assert torch.equal(moe.moe_ffn(p, x, cfg)[0], first)


def test_mla_block_on_the_card_matches_cpu(cuda):
    """deepseek's MLA at full width (16 heads, kv_lora 512, rope 64, nope
    128, v 128), float32: a prefill of 20 in the materialized form, then 4
    absorbed decode steps written into the cache in place."""
    cfg = configs.get("deepseek-v2-lite-16b")
    gen = torch.Generator().manual_seed(2)
    p = attn.init_mla(gen, cfg, torch.float32)
    p["kv_norm"] = 0.1 * torch.randn(p["kv_norm"].shape, generator=gen)
    pc = {k: v.to(cuda) for k, v in p.items()}
    b, s, steps = 2, 20, 4
    x = torch.randn((b, s + steps, cfg.d_model), generator=gen)
    pos = torch.arange(s + steps)[None, :].expand(b, s + steps)

    def run(params, dev):
        out, cache = attn.mla_block(params, x[:, :s].to(dev), cfg, pos[:, :s].to(dev))
        cache = tuple(torch.nn.functional.pad(c, (0, 0, 0, steps)) for c in cache)
        outs = [out]
        for i in range(steps):
            at = torch.full((b,), s + i, device=dev)
            o, _ = attn.mla_block(params, x[:, s + i:s + i + 1].to(dev), cfg, at[:, None],
                                  kv_cache=cache, cache_pos=at)
            outs.append(o)
        return [o.cpu() for o in outs] + [c.cpu() for c in cache]

    for got, want in zip(run(pc, cuda), run(p, "cpu")):
        torch.testing.assert_close(got, want, rtol=MOE_RTOL, atol=MOE_ATOL)


@pytest.mark.parametrize("arch,layers", [("deepseek-v2-lite-16b", 2), ("llama4-scout-17b-a16e", 1)])
def test_engine_moe_families_match_cpu(cuda, arch, layers):
    """Greedy ``Engine.generate`` at full width (deepseek: the MLA prologue
    + 1 MLA+MoE layer, 8 experts; llama4: 1 layer, 4 experts; vocab 512) on
    the card equals the CPU route on the same weights, no hand kernel
    launched."""
    cfg = _moe_cfg(arch).with_overrides(n_layers=layers, vocab=512)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    before = sd.LAUNCHES
    got = Engine(params, cfg, ServeConfig(max_new_tokens=8), device=cuda).generate(prompts)
    assert sd.LAUNCHES == before
    want = Engine(_to_cpu(params), cfg, ServeConfig(max_new_tokens=8),
                  device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, want)


# -- the encoder-decoder family and training: torch ops on the card ------------------


def test_whisper_engine_matches_cpu(cuda):
    """Greedy ``Engine.generate(enc=)`` of whisper-base at full width (1
    encoder and 1 decoder layer, enc_len 1536, vocab 512) on the card
    equals the CPU route on the same weights and frames; no hand kernel."""
    cfg = configs.get("whisper-base").with_overrides(n_layers=1, n_enc_layers=1, vocab=512)
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    enc = rng.standard_normal((4, cfg.enc_len, cfg.d_model)).astype(np.float32)
    before = sd.LAUNCHES
    got = Engine(params, cfg, ServeConfig(max_new_tokens=8), device=cuda).generate(prompts, enc=enc)
    assert sd.LAUNCHES == before
    want = Engine(_to_cpu(params), cfg, ServeConfig(max_new_tokens=8),
                  device="cpu").generate(prompts, enc=enc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,preset,shape", [("whisper-base", "full", ("2", "32")),
                                               ("granite-3-2b", "100m", ("8", "128"))])
def test_launch_train_on_the_card(cuda, arch, preset, shape, capsys):
    """``launch.train`` with no ``--device``: a few steps on the card, the
    reference's ``train_done`` line with finite losses."""
    import re

    from repro_torch.launch import train as t_launch

    assert t_launch.main(["--arch", arch, "--preset", preset, "--steps", "3", "--batch", shape[0],
                          "--seq", shape[1]]) == 0
    out = capsys.readouterr().out
    m = re.search(rf"train_done arch={arch} steps=3 loss_first10=(\S+) loss_last10=(\S+)", out)
    assert m and all(np.isfinite(float(v)) for v in m.groups())


def test_train_step_runs_where_the_parameters_are(cuda):
    """The trainer's step keeps the parameters and the optimizer state on
    the card and updates them in place."""
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainer import make_train_step

    cfg = configs.smoke("granite-3-2b")
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    ptrs = [params["embed"]["tok"].data_ptr(), params["groups"][0]["pos0"]["ln1"].data_ptr()]
    state = init_opt_state(params)
    toks = torch.randint(0, cfg.vocab, (2, 17), device=cuda)
    step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg), OptimizerConfig(lr=1e-3))
    params, state, metrics = step(params, state, {"tokens": toks})
    assert [params["embed"]["tok"].data_ptr(), params["groups"][0]["pos0"]["ln1"].data_ptr()] == ptrs
    assert all(t.device.type == "cuda" for t in (metrics["loss"], state["step"],
                                                 state["m"]["embed"]["tok"]))
    assert np.isfinite(float(metrics["loss"]))

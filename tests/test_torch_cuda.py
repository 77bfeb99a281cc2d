"""The port's CUDA kernels against their plain torch versions, on the card,
through both entries: one dataset (``fused_score_vector``) and a bucket of
datasets (``fused_score_batch``).

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor ``repro``, so it runs on a
machine with only torch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ``fused_score.score_tolerance`` — float32 rounding of each
entropy carried through I and S = sum min(0, I)^2. The kernel and the plain
version take the same float32 formulas and differ only in the order of the
sums.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.covariance import cov_matrix, normalize  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402

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
    """Zero-padded sample columns add exactly 0 to the kernel's raw sums and
    only the divide uses the valid count. The torch prologue (row entropies,
    diagonal tiles) reduces 700 and 1024 columns in different orders, so the
    scores agree to float32 rounding, not bit for bit."""
    p, n, n_pad = 21, 700, 1024
    xn, c = _setup(p, n, 9, cuda)
    xp = torch.zeros((p, n_pad), device=cuda)
    xp[:, :n] = xn
    mask = torch.ones(p, dtype=torch.bool, device=cuda)
    s_exact = fs.fused_score_vector(xn, c, mask)
    s_pad = fs.fused_score_vector(xp, c, mask, n_valid=torch.tensor(n, device=cuda))
    assert torch.all((s_pad - s_exact).abs() <= fs.score_tolerance(s_exact, xn, c, mask))


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
    alone on the same prologue inputs, whatever the batch size."""
    xb, cb, mb, nv = _bucket([(24, 640)] * 6, 640, 7, cuda)
    _, _, _, hxb, mbb, s_diag = fs.fused_layout(xb, cb, mb, 8, n_valid=nv)
    den = nv.float()
    full = fs.launch_batch(xb, cb, hxb, mbb, s_diag, den)
    half = fs.launch_batch(xb[:3].contiguous(), cb[:3].contiguous(), hxb[:3].contiguous(),
                           mbb[:3].contiguous(), s_diag[:3].contiguous(), den[:3].contiguous())
    assert torch.equal(full[:3], half)
    for i in range(xb.shape[0]):
        one = fs.launch(xb[i], cb[i], hxb[i], mbb[i], s_diag[i], den[i:i + 1])
        assert torch.equal(full[i], one)


def test_batch_kernel_is_deterministic(cuda):
    xb, cb, mb, nv = _bucket([(128, 2048), (100, 1900)], 2048, 11, cuda)
    first = fs.fused_score_batch(xb, cb, mb, n_valid=nv)
    for _ in range(3):
        assert torch.equal(fs.fused_score_batch(xb, cb, mb, n_valid=nv), first)

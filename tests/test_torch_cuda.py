"""The port's CUDA kernels against their plain torch versions, on the card.

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

"""Public wrappers for the hand-written kernels + the score-backend resolver.

On a CUDA tensor a kernel wrapper launches its kernel or raises; on a CPU
tensor it runs the kernel's plain torch version (the CPU tests' route).

The score kernels are float32, as the JAX package's Pallas kernels are. A
float64 estimator state (``ParaLiNGAMConfig.dtype``) reaches them through
these wrappers, which give them float32 copies of its operands, as the
reference's kernel wrappers cast theirs; the kernels' own float32 guards
stay, behind the cast. Their scores and sums come back float32.
"""

from __future__ import annotations

import torch

from repro_torch.core.pairwise import pair_moments as _pair_moments
from repro_torch.kernels import covupdate as _covupdate
from repro_torch.kernels import fused_score as _fused
from repro_torch.kernels import pairwise_score as _pairwise
from repro_torch.kernels import ssd_decode as _ssd

#: The score-backend enum. ``torch``/``torch_fused`` are the plain torch
#: formulations (square HR sweep / fused triangular sweep); ``hopper``/
#: ``hopper_fused`` are the kernel routes (square moments kernel / fused
#: triangular kernel); ``auto`` resolves per call site via
#: ``select_backend``.
SCORE_BACKENDS = ("torch", "torch_fused", "hopper", "hopper_fused", "auto")


class BackendUnavailable(ValueError):
    """A requested score backend cannot serve the requested call.

    Raised by ``select_backend`` instead of silently degrading."""


def select_backend(cfg, device) -> str:
    """Resolve a ``score_backend`` request to a concrete backend, once.

    ``cfg`` is either the backend name itself or anything with a
    ``score_backend`` attribute. ``auto`` resolves to ``hopper_fused`` for a
    CUDA device and to ``torch`` (the square plain path) otherwise. Explicit
    requests are honored; ``hopper`` or ``hopper_fused`` on a CPU device runs
    the kernel's plain version.

    Raises ``BackendUnavailable`` for names outside ``SCORE_BACKENDS``."""
    backend = cfg if isinstance(cfg, str) else getattr(cfg, "score_backend", "auto")
    if backend not in SCORE_BACKENDS:
        raise BackendUnavailable(
            f"score_backend={backend!r} is not one of {SCORE_BACKENDS}"
        )
    if backend != "auto":
        return backend
    return "hopper_fused" if getattr(device, "type", device) == "cuda" else "torch"


def _f32(t):
    """A float32 copy of a float64 kernel operand; anything else as it is
    (for the kernel's own checks)."""
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def score_vector(xn, c, mask, *, n_valid=None):
    """Messaging-folded (p,) score vector via the fused triangular kernel at
    its 8-row block. Plain version: ``repro_torch.core.pairwise.fused_scores``."""
    return _fused.fused_score_vector(_f32(xn), _f32(c), mask, block=8, n_valid=n_valid)


def score_batch(xb, cb, maskb, *, n_valid=None):
    """(B, p) score vectors of a bucket of datasets via one launch of the
    batched fused triangular kernel at its 8-row block; ``n_valid`` is None
    or one valid sample count per dataset. Plain version:
    ``fused_score.fused_score_batch_ref``."""
    return _fused.fused_score_batch(_f32(xb), _f32(cb), maskb, block=8, n_valid=n_valid)


def pairwise_moments(xi, xj, c, *, live_i=None, live_j=None, n_valid=None):
    """Raw moment sums (sum log cosh u, sum u exp(-u^2/2)) of every (i, j)
    residual stream of one dataset via the square moments kernel: two
    (pi, pj) tensors, no 1/n, no entropy (finish with
    ``pairwise.finalize_moments``). ``live_i``/``live_j`` bool live rows and
    ``n_valid`` restrict the sums to live pairs (0 elsewhere) and valid
    samples. Plain version: ``pairwise_score.pairwise_moments_ref``."""
    return _pairwise.pairwise_moments(_f32(xi), _f32(xj), _f32(c), live_i=live_i,
                                      live_j=live_j, n_valid=n_valid)


def pairwise_moments_batch(xb, cb, *, mask=None, n_valid=None):
    """The square raw sums of a bucket ``xb: (B, m, n)`` in one launch: two
    (B, m, m) tensors; ``mask: (B, m)`` and ``n_valid: (B,)`` as in
    :func:`pairwise_moments`. Plain version: ``pairwise_moments_batch_ref``."""
    return _pairwise.pairwise_moments_batch(_f32(xb), _f32(cb), mask=mask, n_valid=n_valid)


def residual_entropy_matrix(xn, c, *, mask=None, n_valid=None):
    """(p, p) HR matrix via the square moments kernel + torch entropy
    epilogue. The kernel sums the live pairs of ``mask`` (all rows when
    None) over the first ``n_valid`` samples; ``n_valid`` is also the
    epilogue's denominator."""
    return _pairwise.pairwise_score(_f32(xn), _f32(c), mask=mask, n_valid=n_valid)


def residual_entropy_matrix_batch(xb, cb, *, mask=None, n_valid=None):
    """(B, m, m) HR matrices of a bucket via one launch of the square moments
    kernel; ``mask`` None or (B, m) live rows, ``n_valid`` None or one valid
    count per dataset."""
    return _pairwise.pairwise_score_batch(_f32(xb), _f32(cb), mask=mask, n_valid=n_valid)


def pair_moments(xn, c_vals, xj, n_valid=None, group=None):
    """Both-direction residual entropies of the threshold scheduler's
    gathered comparison chunks (see ``core.pairwise.pair_moments``);
    ``group`` is the ring's sample-shard seam (the raw sums summed across
    its ranks before the entropy).

    The chunk layout is a gather over pending targets, not a dense tile, and
    no kernel takes it: every backend runs the torch formulation, which the
    scheduler calls directly (``core.paralingam._find_root_threshold_impl``).
    This is the name reserved for a gather kernel, as in the JAX package; it
    is not on the scheduler's call path."""
    return _pair_moments(xn, c_vals, xj, n_valid=n_valid, group=group)


def update_data(x, x_root, b):
    """Fused Algorithm 7 rank-1 data refresh via the update_data kernel.
    Plain version: ``covupdate.update_data_ref``; oracle:
    ``ref.update_data_cov_ref``."""
    return _covupdate.update_data(x, x_root, b)


def update_cov(c, b):
    """Fused Algorithm 8 covariance refresh via the update_cov kernel.
    Plain version: ``covupdate.update_cov_ref``."""
    return _covupdate.update_cov(c, b)


def rank1_update(xb, cb, roots, mloc, n_valid=None, *, inplace=False):
    """One scan iteration's rank-1 updates (Algorithms 7 and 8, with the
    fit's gates and drift renormalization) over a bucket ``xb: (B, m, n)``,
    ``cb: (B, m, m)``, one root per dataset, live rows ``mloc: (B, m)`` and
    ``n_valid`` None or (B,), in one launch of the update kernel's fit mode:
    returns ``(xb', cb')``; ``inplace`` writes x' over ``xb``. Plain version:
    ``covupdate.rank1_update_ref`` (``covariance.update_data`` then
    ``update_cov``)."""
    return _covupdate.rank1_update(xb, cb, roots, mloc, n_valid, inplace=inplace)


def ring_update(x_loc, c_loc, x_root, b, s_row, b_col, s_col, live, *, row0: int, n: int,
                reduce=None, inplace=False):
    """The messaging ring's rank-1 update of one rank's row block (rows
    ``row0 ..`` of x's sample shard and of c, the root's row and every gate
    given) via the update kernel's ring mode: one launch, or two around
    ``reduce`` (the sums of squares summed across the sample shards).
    Returns ``(x_loc', c_loc')``. Plain version: ``covupdate.ring_update_ref``
    (the ring's torch update)."""
    return _covupdate.ring_update(x_loc, c_loc, x_root, b, s_row, b_col, s_col, live,
                                  row0=row0, n=n, reduce=reduce, inplace=inplace)


def ssd_decode(state, x, dt, b, c, a, d):
    """Mamba2 SSD decode-step state update via the ssd_decode kernel:
    returns ``(y, new_state)``. Plain version: ``ssd_decode.ssd_decode_ref``."""
    return _ssd.ssd_decode(state, x, dt, b, c, a, d)

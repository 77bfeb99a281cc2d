"""Public wrappers for the hand-written kernels + the score-backend resolver.

On a CUDA tensor a kernel wrapper launches its kernel or raises; on a CPU
tensor it runs the kernel's plain torch version (the CPU tests' route).
"""

from __future__ import annotations

from repro_torch.kernels import fused_score as _fused

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
    requests are honored; ``hopper_fused`` on a CPU device runs the kernel's
    plain version.

    Raises ``BackendUnavailable`` for names outside ``SCORE_BACKENDS`` and
    for ``hopper``, whose square moments kernel is not ported yet."""
    backend = cfg if isinstance(cfg, str) else getattr(cfg, "score_backend", "auto")
    if backend not in SCORE_BACKENDS:
        raise BackendUnavailable(
            f"score_backend={backend!r} is not one of {SCORE_BACKENDS}"
        )
    if backend == "hopper":
        raise BackendUnavailable(
            "score_backend='hopper' needs the square moments kernel, which is "
            "not ported yet (ROADMAP.md, queue 2 item 3); use 'hopper_fused', "
            "'torch' or 'torch_fused'"
        )
    if backend != "auto":
        return backend
    return "hopper_fused" if getattr(device, "type", device) == "cuda" else "torch"


def score_vector(xn, c, mask, *, n_valid=None):
    """Messaging-folded (p,) score vector via the fused triangular kernel at
    its 8-row block. Plain version: ``repro_torch.core.pairwise.fused_scores``."""
    return _fused.fused_score_vector(xn, c, mask, block=8, n_valid=n_valid)


def score_batch(xb, cb, maskb, *, n_valid=None):
    """(B, p) score vectors of a bucket of datasets via one launch of the
    batched fused triangular kernel at its 8-row block; ``n_valid`` is None
    or one valid sample count per dataset. Plain version:
    ``fused_score.fused_score_batch_ref``."""
    return _fused.fused_score_batch(xb, cb, maskb, block=8, n_valid=n_valid)

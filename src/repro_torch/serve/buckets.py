"""Canonical shape-bucketing helpers of the serving stack.

jit compiles one executable per shape, so every engine wins throughput by
collapsing ragged request shapes onto a small pow-2 grid and zero-padding up
to it. This module is the single home of that grid logic; ``serve.batching``
and ``serve.lingam_engine`` re-export these names for compatibility (they
each used to carry their own copy of half the family).

Zero-padding is the contract, not a convenience: dead variable rows and
padded sample columns must be *exactly* zero so the mask/``n_valid`` seams
(``pairwise.finalize_moments`` / ``covariance._sample_count``) reproduce the
unpadded statistics bit-for-bit — including through the Pallas kernel
backends, whose raw moment sums are invariant to zero columns.
"""

from __future__ import annotations

import numpy as np

from repro_torch.utils.shapes import next_pow2


def bucket_dim(v: int, floor: int = 1) -> int:
    """One dimension of the pow-2 bucket grid: ``next_pow2`` with a floor so
    tiny requests share one executable instead of one each."""
    return max(floor, next_pow2(v))


def bucket_dims(shape, floors) -> tuple[int, ...]:
    """Pow-2 bucket for a whole shape (elementwise ``bucket_dim``)."""
    return tuple(bucket_dim(v, f) for v, f in zip(shape, floors))


def pad_to(x: np.ndarray, shape, dtype=None) -> np.ndarray:
    """Zero-pad ``x`` up to ``shape`` (leading corner). Zeros are the padding
    contract of the mask/``n_valid`` seams: dead rows and padded sample
    columns must be exactly zero."""
    out = np.zeros(shape, dtype or x.dtype)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def bucket_shape(p: int, n: int, cfg) -> tuple[int, int]:
    """The padded (p, n) executable bucket a request shape lands in. ``cfg``
    is anything with ``min_p_bucket``/``min_n_bucket`` floors (the LiNGAM
    engines' ``LingamServeConfig``)."""
    return bucket_dims((p, n), (cfg.min_p_bucket, cfg.min_n_bucket))


def pad_dataset(x: np.ndarray, p_pad: int, n_pad: int) -> np.ndarray:
    """Zero-pad one ``x: (p, n)`` dataset to (p_pad, n_pad) float64."""
    return pad_to(x, (p_pad, n_pad), np.float64)

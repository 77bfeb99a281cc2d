"""Deterministic synthetic data pipelines.

Port of ``src/repro/data/synthetic.py``. ``TokenStream`` is an infinite,
seekable LM token stream: batch ``i`` is a pure function of (seed, i), so a
restarted job resumes exactly where its checkpoint left off with no data
state to save beyond the step counter. Tokens follow a Zipf-like marginal
with short-range structure (a noisy Markov walk), so the loss decreases.
``batch_at`` is numpy, the reference's own code, and gives its bits;
``tensor_batch_at`` puts the batch on a device (the card unless
``device="cpu"``) in place of the reference's ``jax_batch_at``.

``lingam_batches`` splits a LiNGAM observation matrix into the (row,
sample) grid of the distributed ring.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.paralingam import _device


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    batch: int
    seq_len: int  # number of *predicted* tokens; batches are (B, seq_len+1)
    seed: int = 0

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s = self.batch, self.seq_len + 1
        # Zipf-ish unigram with Markov smoothing: next = prev + small step mod V
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        base = np.minimum(base, self.vocab - 1)
        drift = rng.integers(-3, 4, size=(b, s))
        walk = np.cumsum(drift, axis=1)
        toks = (base + walk) % self.vocab
        return toks.astype(np.int32)

    def tensor_batch_at(self, step: int, device=None) -> torch.Tensor:
        """``batch_at(step)`` as an int64 tensor on ``device``."""
        dev = _device(device, "repro_torch.data.synthetic.TokenStream.tensor_batch_at")
        return torch.as_tensor(self.batch_at(step), dtype=torch.int64, device=dev)


def lingam_batches(x: np.ndarray, n_row_shards: int, n_col_shards: int):
    """Split an observation matrix (p, n) into the (row, sample) grid used by
    the distributed ring (rows -> data axis, samples -> model axis)."""
    p, n = x.shape
    if p % n_row_shards or n % n_col_shards:
        raise ValueError(f"({p}, {n}) does not split into {n_row_shards} x {n_col_shards}")
    rows = np.split(x, n_row_shards, axis=0)
    return [np.split(r, n_col_shards, axis=1) for r in rows]

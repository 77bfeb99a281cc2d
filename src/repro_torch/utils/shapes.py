"""Shape bucketing helpers.

Power-of-two padding is the bucketing convention of the causal-order
driver: the live-row count is padded to a power of two so ragged stages
collapse onto a logarithmic number of buffer shapes.
"""

from __future__ import annotations


def next_pow2(v: int) -> int:
    """Smallest power of two >= ``v`` (``v <= 1`` -> 1)."""
    out = 1
    while out < v:
        out *= 2
    return out

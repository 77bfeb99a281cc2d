"""Assigned input shapes and (arch x shape) applicability."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention / O(1) state: run only for SSM and
# hybrid archs (DESIGN.md "Shape skips").
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, (
            "long_500k skipped: full-attention KV cache at 524288 tokens is "
            "infeasible (e.g. yi-34b ~126 GB/sequence) and prefill is "
            "quadratic; run only for SSM/hybrid archs"
        )
    return True, ""

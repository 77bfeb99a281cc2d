"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    deepseek_v2_lite_16b,
    gemma3_12b,
    gemma_7b,
    granite_3_2b,
    lingam,
    llama4_scout_17b_a16e,
    mamba2_370m,
    whisper_base,
    yi_34b,
    zamba2_2_7b,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable

_MODULES = {
    "yi-34b": yi_34b,
    "gemma3-12b": gemma3_12b,
    "granite-3-2b": granite_3_2b,
    "gemma-7b": gemma_7b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mamba2-370m": mamba2_370m,
    "zamba2-2.7b": zamba2_2_7b,
    "whisper-base": whisper_base,
    "chameleon-34b": chameleon_34b,
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str):
    """Full-size ArchConfig by id."""
    return _MODULES[name].CONFIG


def smoke(name: str):
    """Reduced same-family config for CPU smoke tests."""
    return _MODULES[name].SMOKE


LINGAM_CONFIGS = lingam.ALL

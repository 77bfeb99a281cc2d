"""Config presets of the training command line.

Only :func:`preset_config` is ported so far: ``launch/serve.py`` shares it.
The training loop (optimizer, checkpoints, the fault-tolerant trainer)
comes with the training slice (ROADMAP.md queue 1 item 4).

Presets: ``smoke`` (reduced config), ``100m`` (~100M-param variant of the
arch family), ``full`` (the published config).
"""

from __future__ import annotations

from repro_torch import configs


def preset_config(arch: str, preset: str):
    if preset == "full":
        return configs.get(arch)
    if preset == "smoke":
        return configs.smoke(arch)
    if preset == "100m":
        base = configs.smoke(arch)
        return base.with_overrides(
            n_layers=base.group_size * 8,
            d_model=512,
            n_heads=8,
            n_kv_heads=4,
            head_dim=64,
            d_ff=2048,
            d_ff_expert=min(512, base.d_ff_expert) if base.d_ff_expert else 0,
            vocab=8192,
            ssm_headdim=32 if base.family in ("ssm", "hybrid") else base.ssm_headdim,
        )
    raise ValueError(preset)

"""The LM substrate of the port: the dense attention, sliding-window, MLA
and MoE (deepseek-v2-lite, llama4-scout), SSM (Mamba2) and hybrid (Zamba2)
families.

``lm`` assembles the model from ``layers``, ``attention`` (MLA included),
``moe`` and ``ssm``; ``convert`` carries the JAX package's parameters
across. The encoder-decoder family (ROADMAP.md queue 1 item 3) is not
ported yet: ``lm`` raises ``NotPorted`` for its layer kind.
"""

from repro_torch.models.config import ArchConfig

"""The LM substrate of the port: the Mamba2 (SSM) family so far.

``lm`` assembles the model from ``layers`` and ``ssm``; ``convert`` carries
the JAX package's parameters across. The attention, MLA, MoE, hybrid and
encoder-decoder families are not ported yet (ROADMAP.md queue 1 item 10):
``lm`` raises ``NotPorted`` for their layer kinds. ``attention.py`` and
``moe.py`` have no counterpart here.
"""

from repro_torch.models.config import ArchConfig

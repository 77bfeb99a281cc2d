"""The LM substrate of the port: the dense attention, sliding-window, SSM
(Mamba2) and hybrid (Zamba2) families.

``lm`` assembles the model from ``layers``, ``attention`` and ``ssm``;
``convert`` carries the JAX package's parameters across. MLA and MoE
(ROADMAP.md queue 1 item 2) and the encoder-decoder family (item 3) are not
ported yet: ``lm`` raises ``NotPorted`` for their layer kinds, and
``moe.py`` has no counterpart here.
"""

from repro_torch.models.config import ArchConfig

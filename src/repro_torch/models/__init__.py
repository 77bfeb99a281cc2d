"""The LM substrate of the port: the dense attention, sliding-window, MLA
and MoE (deepseek-v2-lite, llama4-scout), SSM (Mamba2), hybrid (Zamba2)
and encoder-decoder (whisper) families.

``lm`` assembles the model from ``layers``, ``attention`` (MLA included),
``moe`` and ``ssm``, with the training loss (``train_loss``); ``convert``
carries the JAX package's parameters and optimizer state across.
"""

from repro_torch.models.config import ArchConfig

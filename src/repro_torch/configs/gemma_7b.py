"""Gemma-7B [arXiv:2403.08295; hf] — GeGLU, head_dim 256 (q-dim 4096 !=
d_model, explicit o-proj)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab=512, remat=False,
)

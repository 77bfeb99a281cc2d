"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base] — dense GQA, tied
embeddings."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=49155,
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, remat=False,
)

"""Gemma-3-12B [hf:google/gemma-3-*-pt] — 5:1 local:global attention,
window 1024, GeGLU, qk-norm, 262k vocab."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    act="geglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    window=1024,
    local_global_ratio=5,  # groups of 5 local + 1 global
)

SMOKE = CONFIG.with_overrides(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window=8, remat=False,
)

"""Zamba2-2.7B [arXiv:2411.15242; hf] — 54 Mamba2 layers + shared-weight
attention block applied every 6th layer (concat with the initial embedding,
2d->d projection per application)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="geglu",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    hybrid_attn_every=6,
)

SMOKE = CONFIG.with_overrides(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    hybrid_attn_every=2, remat=False,
)

"""Mamba2-370M [arXiv:2405.21060] — pure SSD (state-space duality),
attention-free."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,  # attention-free; placeholders
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, remat=False,
)

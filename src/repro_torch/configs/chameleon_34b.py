"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM: VQ image tokens share
the 65536 vocab, so the backbone is a plain dense LM over token ids (the VQ
tokenizer frontend is a stub); qk-norm per the paper."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    act="swiglu",
    qk_norm=True,
    frontend="vq",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, remat=False,
)

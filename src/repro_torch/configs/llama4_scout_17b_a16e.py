"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE 16
experts top-1 + shared expert, early fusion."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    act="swiglu",
    rope_theta=500_000.0,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    d_ff_expert=8192,
    d_ff_shared=8192,
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, d_ff_expert=128, d_ff_shared=128,
    remat=False,
)

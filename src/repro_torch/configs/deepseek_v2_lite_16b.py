"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf] — MLA (kv_lora 512, rope 64,
nope 128), 64 routed experts top-6 + 2 shared, first layer dense."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,  # v head dim
    d_ff=10944,  # dense prologue layer FF
    vocab=102400,
    act="swiglu",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    d_ff_shared=1408,
    first_dense_layers=1,
    mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
)

SMOKE = CONFIG.with_overrides(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab=512, n_experts=8, top_k=2, d_ff_expert=32,
    d_ff_shared=32, kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32,
    remat=False,
)

"""Whisper-base [arXiv:2212.04356] — enc-dec transformer backbone; the conv
audio frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, enc_len, d_model). enc_len padded 1500 -> 1536 for mesh
divisibility (DESIGN.md)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    act="geglu",
    enc_dec=True,
    n_enc_layers=6,
    enc_len=1536,
    frontend="audio",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, enc_len=24, remat=False,
)

"""Architecture configuration: one frozen dataclass drives every model."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


def round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention / position
    act: str = "swiglu"  # swiglu | geglu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0  # sliding-window size (0 = full attention)
    local_global_ratio: int = 0  # k -> groups of (k local + 1 global) layers
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense layers (deepseek-v2)

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # hybrid (zamba2): one *shared-weight* attention block applied every k
    # SSM layers (concat with the initial embedding, 2d -> d projection).
    hybrid_attn_every: int = 0

    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1536  # padded from whisper's 1500 frames for mesh divisibility
    frontend: str = ""  # "audio" | "vq" — modality frontends are stubs

    # numerics / structure
    dtype: str = "bfloat16"
    kv_quant: str = ""  # "" | "int8" — quantized KV cache (decode bandwidth)
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | default
    scan_layers: bool = True
    # dry-run override: lower only this many groups (roofline L-delta trick)
    n_groups_override: int = 0

    # ------------------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_layer_based(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def group_size(self) -> int:
        """Layers per scanned group (see lm.py layer grouping)."""
        if self.local_global_ratio > 0:
            return self.local_global_ratio + 1
        if self.hybrid_attn_every > 0:
            return self.hybrid_attn_every
        return 1

    @property
    def n_groups(self) -> int:
        body = self.n_layers - self.first_dense_layers
        assert body % self.group_size == 0, (
            f"{self.name}: {body} layers not divisible into groups of {self.group_size}"
        )
        n = body // self.group_size
        if self.n_groups_override:
            n = min(n, self.n_groups_override)
        return n

    def with_overrides(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    # Analytic parameter counts (used for MODEL_FLOPS = 6 N D and memory napkins).

    def param_count(self, active_only: bool = False) -> int:
        d, v = self.d_model, self.vocab_padded
        embed = v * d * (1 if self.tie_embeddings else 2)
        total = embed
        n_body = self.n_groups * self.group_size + self.first_dense_layers
        for layer_idx in range(n_body):
            total += self._layer_params(layer_idx, active_only)
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += self._shared_attn_params()
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            r = self.kv_lora_rank
            qd = self.n_heads * (self.nope_head_dim + self.rope_head_dim)
            kv_up = r * self.n_heads * (self.nope_head_dim + self.head_dim)
            return d * qd + d * (r + self.rope_head_dim) + kv_up + self.n_heads * self.head_dim * d
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _mlp_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # gate + up + down

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, n, h = self.ssm_ngroups, self.ssm_state, self.n_ssm_heads
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = (di + 2 * g * n) * self.ssm_conv
        out = di * d
        return in_proj + conv + out + 3 * h + di  # A, D, dt_bias, gated-norm

    def _shared_attn_params(self) -> int:
        d = self.d_model
        return 2 * d * d + self._attn_params() + self._mlp_params(self.d_ff)

    def _layer_params(self, layer_idx: int, active_only: bool) -> int:
        d = self.d_model
        if self.family in ("ssm", "hybrid"):
            return self._ssm_params() + 2 * d
        total = self._attn_params() + 2 * d  # attn + 2 norms
        dense_layer = (not self.is_moe) or (layer_idx < self.first_dense_layers)
        if dense_layer:
            total += self._mlp_params(self.d_ff)
        else:
            n_routed = self.top_k if active_only else self.n_experts
            total += self.d_model * self.n_experts  # router
            total += n_routed * self._mlp_params(self.d_ff_expert) // 1
            if self.n_shared_experts:
                total += self.n_shared_experts * self._mlp_params(
                    self.d_ff_shared or self.d_ff_expert
                )
        return total

"""Model configuration, derived from the .m header (src/llm.hpp:39-67)."""

from __future__ import annotations

from dataclasses import dataclass

from ..formats.model_file import HiddenAct, ModelHeader, RopeType


@dataclass(frozen=True)
class LlamaConfig:
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    hidden_act: int = HiddenAct.SILU
    rope_theta: float = 10000.0
    rope_type: int = RopeType.LLAMA
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    norm_epsilon: float = 1e-5
    n_experts: int = 0
    n_active_experts: int = 0
    qkv_bias: int = 0  # Qwen2-family: add per-layer q/k/v projection biases

    def __post_init__(self):
        if self.n_experts > 0 and not (1 <= self.n_active_experts <= self.n_experts):
            raise ValueError(
                f"MoE config needs 1 <= n_active_experts <= n_experts, got "
                f"n_active_experts={self.n_active_experts}, n_experts={self.n_experts}"
            )

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @staticmethod
    def from_header(h: ModelHeader) -> "LlamaConfig":
        return LlamaConfig(
            dim=h.dim,
            hidden_dim=h.hidden_dim,
            n_layers=h.n_layers,
            n_heads=h.n_heads,
            n_kv_heads=h.n_kv_heads,
            vocab_size=h.vocab_size,
            seq_len=h.seq_len,
            hidden_act=h.hidden_act,
            rope_theta=h.rope_theta,
            rope_type=h.rope_type,
            rope_scaling_factor=h.rope_scaling_factor,
            rope_scaling_low_freq_factor=h.rope_scaling_low_freq_factor,
            rope_scaling_high_freq_factor=h.rope_scaling_high_freq_factor,
            rope_scaling_orig_max_seq_len=h.rope_scaling_orig_max_seq_len,
            norm_epsilon=h.norm_epsilon,
            n_experts=h.n_experts,
            n_active_experts=h.n_active_experts,
            qkv_bias=h.qkv_bias,
        )

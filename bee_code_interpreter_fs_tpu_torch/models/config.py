"""LlamaConfig: the port's own copy of the JAX package's model config.

Same fields, defaults and presets as the reference, so a config built on
either side describes the same model. Some fields select paths this
package does not run yet; the code that would need them raises
NotImplementedError and names the slice that brings them (see
``check_supported``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Mixture-of-experts: 0 = dense MLP (the only MLP this package runs).
    n_experts: int = 0
    n_experts_per_token: int = 2
    # Single-device attention: "plain" (dense scores) or "flash" (the CUDA
    # kernel, ops/flash_attention.py).
    attn_impl: str = "plain"
    # Rematerialization on the backward pass (training slice).
    remat: bool = False
    moe_impl: str = "dense"
    moe_capacity_factor: float = 1.25
    # Sequence-parallel strategy for meshes with sp > 1 (parallel slice).
    sp_impl: str = "ring"
    # Sliding-window attention: each position sees at most the last
    # `sliding_window` keys (itself included). 0 = full causal.
    sliding_window: int = 0
    # StreamingLLM attention sinks: with a window, the first
    # `attention_sinks` positions stay visible to every query.
    attention_sinks: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Small config for tests and dry runs."""
        base = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
            hidden_dim=128, max_seq_len=128,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**overrides)  # defaults are the 7B shape

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        """Llama-2-13B geometry: 40L / 5120 / 13824, MHA."""
        return LlamaConfig(
            vocab_size=32000, dim=5120, n_layers=40, n_heads=40,
            n_kv_heads=40, hidden_dim=13824, max_seq_len=4096,
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """Llama-3-8B geometry: GQA 32q/8kv, 128k vocab, theta 5e5."""
        return LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, hidden_dim=14336, max_seq_len=8192,
            rope_theta=500000.0,
        )

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        """Mixtral-8x7B geometry: 8 experts, top-2 routing, GQA 32q/8kv."""
        return LlamaConfig(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, hidden_dim=14336, max_seq_len=32768,
            rope_theta=1000000.0, n_experts=8, n_experts_per_token=2,
        )


def check_supported(cfg: LlamaConfig) -> None:
    """Raise NotImplementedError for config paths later slices bring."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts layers (n_experts > 0) come with the "
            "training/MoE slice of the port"
        )
    if cfg.remat:
        raise NotImplementedError(
            "remat (activation rematerialization) comes with the "
            "training/MoE slice of the port"
        )
    if cfg.attn_impl not in ("plain", "flash"):
        raise ValueError(
            f"attn_impl must be 'plain' or 'flash', got {cfg.attn_impl!r}"
        )

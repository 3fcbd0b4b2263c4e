"""Kimi K2 — trillion-parameter MoE (paper-table figures). [arXiv:2501.kimi2]"""
from repro_torch.configs.base import ModelConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,                 # per-expert FFN width
        vocab_size=163840,
        num_experts=384,
        experts_per_token=8,
        activation="swiglu",
        norm="rmsnorm",
        rope=True,
        citation="arXiv:2501.kimi2",
    )

"""Grok-1 314B — 8-expert top-2 MoE. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig, register


@register("grok-1-314b")
def grok_1_314b() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        activation="geglu",       # gated GeLU: matches the published 314B total
        norm="rmsnorm",
        rope=True,
        citation="hf:xai-org/grok-1",
    )

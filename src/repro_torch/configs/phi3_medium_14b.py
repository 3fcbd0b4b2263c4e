"""Phi-3-medium-14B — dense RoPE + SwiGLU + GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, register


@register("phi3-medium-14b")
def phi3_medium_14b() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        activation="swiglu",
        norm="rmsnorm",
        rope=True,
        serve_window=4096,
        citation="arXiv:2404.14219",
    )

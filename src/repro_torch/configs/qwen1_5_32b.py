"""Qwen1.5-32B — dense MHA with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def qwen1_5_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,           # full MHA
        d_ff=27392,
        vocab_size=152064,
        activation="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope=True,
        serve_window=4096,
        citation="hf:Qwen/Qwen1.5-0.5B",
    )

"""Nemotron-4-340B — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig, register


@register("nemotron-4-340b")
def nemotron_4_340b() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        activation="relu2",        # squared ReLU
        norm="layernorm",
        rope=True,
        serve_window=4096,         # sliding-window serving variant for long_500k
        citation="arXiv:2402.16819",
    )

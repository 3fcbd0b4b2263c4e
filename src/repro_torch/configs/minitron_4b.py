"""Minitron-4B — pruned Nemotron (dense GQA, squared-ReLU). [arXiv:2407.14679]"""
from repro_torch.configs.base import ModelConfig, register


@register("minitron-4b")
def minitron_4b() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=9216,
        vocab_size=256000,
        activation="relu2",
        norm="layernorm",
        rope=True,
        serve_window=4096,
        citation="arXiv:2407.14679",
    )

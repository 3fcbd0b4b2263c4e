"""RecurrentGemma-2B — hybrid RG-LRU + local attention, 1 attn : 2
recurrent. [arXiv:2402.19427]

26 layers with cyclic pattern (R, R, L): two RG-LRU recurrent blocks then
one local (sliding-window 2048) attention block; 26 = 8x3 + 2 so the last
two layers form an unrolled (R, R) tail.
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,            # MQA
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        activation="geglu",
        norm="rmsnorm",
        rope=True,
        block_pattern=("R", "R", "L"),
        window=2048,
        lru_width=2560,
        conv1d_width=4,
        citation="arXiv:2402.19427",
    )

"""xLSTM-350M — alternating sLSTM + mLSTM blocks, no FFN (the blocks carry
their own up-projections). [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,                    # xLSTM blocks have internal projections
        vocab_size=50304,
        activation="gelu",
        norm="layernorm",
        rope=False,
        block_pattern=("S", "M"),
        citation="arXiv:2405.04517",
    )

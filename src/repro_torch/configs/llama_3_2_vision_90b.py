"""Llama-3.2-Vision-90B — decoder with interleaved cross-attention image
layers. [hf:meta-llama/Llama-3.2-11B-Vision]

100 layers total = 80 self-attention + 20 cross-attention (every 5th layer
attends to vision-patch embeddings). The ViT/SigLIP vision tower +
projector frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings (batch, vision_tokens, vision_dim); only the projector that
maps them into d_model is part of this model.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-90b")
def llama_3_2_vision_90b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        activation="swiglu",
        norm="rmsnorm",
        rope=True,
        rope_theta=500000.0,
        block_pattern=("A", "A", "A", "A", "X"),
        vision_tokens=1601,        # 1 tile x (40x40 patches + cls)
        vision_dim=1280,
        citation="hf:meta-llama/Llama-3.2-11B-Vision",
    )

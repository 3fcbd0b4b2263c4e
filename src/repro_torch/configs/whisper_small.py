"""Whisper-small — encoder-decoder audio backbone. [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor frontend is a STUB per the
task carve-out: ``input_specs`` provides precomputed frame embeddings of
shape (batch, encoder_seq_len, d_model).
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,             # decoder layers
        encoder_layers=12,
        encoder_seq_len=1500,      # 30 s of audio at 50 Hz after conv frontend
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
        rope=False,
        learned_pos_embed=1500,
        qkv_bias=True,
        mlp_bias=True,
        citation="arXiv:2212.04356",
    )

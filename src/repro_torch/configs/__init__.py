"""Configurations: the client models and protocol hyperparameters
(`paper_models`) and the transformer zoo (`base` and one module per
architecture), copies of the JAX package's `configs`. Importing this
package registers all architectures."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    get_config,
    list_archs,
    register,
    supports_shape,
)

# side-effect registration of the assigned architectures
from repro_torch.configs import (  # noqa: F401
    grok_1_314b,
    kimi_k2_1t_a32b,
    llama_3_2_vision_90b,
    minitron_4b,
    nemotron_4_340b,
    phi3_medium_14b,
    qwen1_5_32b,
    recurrentgemma_2b,
    whisper_small,
    xlstm_350m,
)

ALL_ARCHS = [
    "kimi-k2-1t-a32b",
    "whisper-small",
    "nemotron-4-340b",
    "llama-3.2-vision-90b",
    "qwen1.5-32b",
    "recurrentgemma-2b",
    "minitron-4b",
    "grok-1-314b",
    "xlstm-350m",
    "phi3-medium-14b",
]

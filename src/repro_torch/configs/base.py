"""Configuration system for the repro framework (the port's copy of
`repro/configs/base.py`; the tests hold every registered config equal
to the JAX package's, field by field).

Every architecture (the paper's own client models plus the ten assigned
public-literature architectures) is described by a frozen ``ModelConfig``.
Input shapes (train / prefill / decode / long-decode) are ``ShapeConfig``s.
A registry maps ``--arch <id>`` strings to configs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

# Block-type codes used in ``block_pattern`` (repeated cyclically over depth):
#   "A" global causal self-attention
#   "L" local (sliding-window) causal self-attention
#   "X" cross-attention (VLM image layers / enc-dec handled separately)
#   "R" RG-LRU recurrent block (RecurrentGemma)
#   "S" sLSTM block (xLSTM)
#   "M" mLSTM block (xLSTM)
VALID_BLOCKS = frozenset("ALXRSM")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0             # 0 -> dense MLP
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- activations / norms / biases ---
    activation: str = "swiglu"       # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    qkv_bias: bool = False
    mlp_bias: bool = False
    # --- positions ---
    rope: bool = True
    rope_theta: float = 10000.0
    learned_pos_embed: int = 0       # >0: learned positional table of this size
    # --- depth pattern (cycled; remainder layers form an unrolled tail) ---
    block_pattern: Tuple[str, ...] = ("A",)
    window: int = 0                  # sliding window for "L" blocks
    serve_window: int = 0            # >0: sliding-window serving variant exists
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq_len: int = 0         # e.g. 1500 mel frames
    # --- vlm ---
    vision_tokens: int = 0           # patch-embedding count from the stub tower
    vision_dim: int = 0              # raw patch-embedding dim (projector input)
    # --- recurrent dims ---
    lru_width: int = 0               # RG-LRU width (0 -> d_model)
    conv1d_width: int = 4
    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    citation: str = ""

    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
        assert all(b in VALID_BLOCKS for b in self.block_pattern), self.block_pattern
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ---- derived quantities ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def pattern_reps(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def pattern_tail(self) -> int:
        return self.num_layers % len(self.block_pattern)

    def layer_type(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, dh = self.d_model, self.resolved_head_dim
        h, kv = self.num_heads, self.num_kv_heads
        n = self.vocab_size * d                          # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size                     # lm head
        if self.learned_pos_embed:
            n += self.learned_pos_embed * d
        for i in range(self.num_layers):
            t = self.layer_type(i)
            n += d  # pre-norm scale
            if t in ("A", "L", "X"):
                n += d * h * dh + 2 * d * kv * dh + h * dh * d
                if self.qkv_bias:
                    n += (h + 2 * kv) * dh
            elif t == "R":
                w = self.lru_width or d
                n += d * w * 2 + self.conv1d_width * w + 3 * w + w * d
            elif t == "S":
                n += 4 * d * d + 4 * d * d // max(self.num_heads, 1) + 8 * d
            elif t == "M":
                n += 2 * d * 2 * d + (2 * d) * dh * 3 + 2 * d * 2 + 2 * d * d
            if t in ("A", "L", "X") or (t in "RSM" and self.d_ff > 0):
                f = self.d_ff
                if f > 0:
                    n += d  # post-norm
                    if self.is_moe:
                        gates = 2 if self.activation in ("swiglu", "geglu") else 1
                        n += d * self.num_experts  # router
                        n += self.num_experts * (gates * d * f + f * d)
                    else:
                        gates = 2 if self.activation in ("swiglu", "geglu") else 1
                        n += gates * d * f + f * d
        if self.is_encdec:
            # encoder self-attn + mlp, decoder gets an extra cross-attn per layer
            f = self.d_ff
            per_enc = 2 * d + d * h * dh + 2 * d * kv * dh + h * dh * d + 2 * d * f + f * d
            n += self.encoder_layers * per_enc
            n += self.num_layers * (d + d * h * dh + 2 * d * kv * dh + h * dh * d)
        if self.vision_tokens:
            n += (self.vision_dim or d) * d              # projector
        n += d                                           # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        gates = 2 if self.activation in ("swiglu", "geglu") else 1
        per_expert = gates * self.d_model * self.d_ff + self.d_ff * self.d_model
        inactive = (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - self.num_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2-ish layers, d_model<=512, <=4 experts.

        The block pattern is compressed to one occurrence of each distinct
        block type so every code path of the family is still exercised.
        """
        seen, pat = set(), []
        for b in self.block_pattern:
            if b not in seen:
                seen.add(b)
                pat.append(b)
        pat = tuple(pat[:2]) if len(pat) > 2 else tuple(pat)
        n_layers = max(2, len(pat))
        d = 256
        heads = 4
        kvh = max(1, heads * self.num_kv_heads // self.num_heads)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=64,
            d_ff=0 if self.d_ff == 0 else 512,
            vocab_size=1024,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            block_pattern=pat,
            window=min(self.window, 64) if self.window else 0,
            serve_window=min(self.serve_window, 64) if self.serve_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq_len=16 if self.encoder_seq_len else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            vision_dim=64 if self.vision_dim else 0,
            lru_width=256 if self.lru_width else 0,
            learned_pos_embed=128 if self.learned_pos_embed else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import side-effect registration
        from repro_torch.configs import ALL_ARCHS  # noqa: F401
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    from repro_torch.configs import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is exercised, and why not if skipped.

    long_500k needs sub-quadratic serving: native for SSM/hybrid archs,
    via the sliding-window variant for dense archs that define one, and
    skipped for full-attention MoE / enc-dec / VLM archs (see DESIGN.md).
    Encoder-decoder 'decode' uses the decoder with a fixed encoder context,
    which is supported; but 500k-token audio decode is out of scope.
    """
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        if cfg.family == "dense" and cfg.serve_window > 0:
            return True, "sliding-window serving variant"
        return False, (f"{cfg.name} is full-attention ({cfg.family}); no "
                       "sub-quadratic serving path — skipped per DESIGN.md")
    return True, ""

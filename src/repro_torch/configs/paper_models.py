"""The paper's own client-model families (WPFed §4.3) and the protocol
hyperparameters, for the PyTorch port.

The port keeps its own copy of these numpy-free dataclasses so that it
imports nothing of the JAX package; `tests/test_torch_protocol.py`
holds the copy field-for-field equal to the JAX package's. The models
themselves live in `repro_torch.models.client`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ClientModelConfig:
    name: str
    kind: str                      # "cnn" | "tcn" | "mlp"
    input_shape: Tuple[int, ...]   # per-example feature shape
    num_classes: int
    hidden: Tuple[int, ...] = (64, 64)
    kernel_size: int = 3
    citation: str = ""


def mnist_cnn() -> ClientModelConfig:
    """Depthwise-separable CNN in the MobileNetV2 spirit (inverted residual
    bottlenecks are reduced to two separable conv stages — appropriate at
    28x28x1 scale; the paper's full MobileNetV2 targets 224x224x3)."""
    return ClientModelConfig(
        name="mnist-cnn",
        kind="cnn",
        input_shape=(28, 28, 1),
        num_classes=10,
        hidden=(32, 64),
        kernel_size=3,
        citation="Sandler et al. 2018 (MobileNetV2), adapted",
    )


def aecg_tcn() -> ClientModelConfig:
    """TCN over 60-dim RR-interval vectors; binary apnea classification."""
    return ClientModelConfig(
        name="aecg-tcn",
        kind="tcn",
        input_shape=(60, 1),
        num_classes=2,
        hidden=(32, 32, 32),
        kernel_size=5,
        citation="Ismail et al. 2023 (TCN), Cai & Hu 2020 preprocessing",
    )


def seeg_tcn() -> ClientModelConfig:
    """TCN for 3-class sleep staging (awake / NREM / REM)."""
    return ClientModelConfig(
        name="seeg-tcn",
        kind="tcn",
        input_shape=(100, 1),
        num_classes=3,
        hidden=(32, 32, 32),
        kernel_size=5,
        citation="Rechtschaffen 1968 staging; Mourtazaev et al. 1995",
    )


@dataclass(frozen=True)
class FedConfig:
    """WPFed protocol hyperparameters (paper Table 1 optima)."""
    num_clients: int = 10
    num_neighbors: int = 12        # N
    alpha: float = 0.6             # local/collaborative trade-off
    gamma: float = 1.0             # LSH-similarity weighting
    top_k: int = 5                 # K in the ranking score (Eq. 7)
    lsh_bits: int = 256            # b
    rounds: int = 100
    local_steps: int = 5
    local_batch: int = 64
    lr: float = 1e-3
    ref_batch: int = 64            # reference-set size exchanged per round
    seed: int = 0
    # kernel-backed subsystem backends, one per subsystem, all resolved
    # by repro_torch.core.backends.resolve: "kernel" launches the CUDA
    # kernels (CUDA tensors only), "oracle" runs their plain PyTorch
    # versions, "auto" is kernel on a CUDA device and oracle on the CPU.
    # Selection also takes "ann", the LSH-bucket candidate index
    # (core/ann.py + the ANN selection kernel), which "auto" picks past
    # backends.ANN_AUTO_MIN_M clients and ANN_AUTO_MIN_RATIO.
    selection_backend: str = "auto"   # Eq. 5-8 selection (DESIGN.md §4, §11)
    exchange_backend: str = "auto"    # Eq. 3 + §3.5 exchange (DESIGN.md §7)
    # ANN selection knobs (DESIGN.md §11): clients sharing a seeded
    # `ann_prefix_bits`-bit code prefix bucket together
    # (2^prefix_bits buckets); each client additionally probes the
    # buckets reached by flipping up to `ann_probes` single prefix
    # bits — the standard multi-probe recall knob. prefix_bits=0
    # collapses to ONE bucket and is pinned bit-exact vs the exact
    # kernels. Effective values are clamped (core.ann) to the code
    # length and to MAX_PREFIX_BITS.
    ann_prefix_bits: int = 10
    ann_probes: int = 8
    # kernel tiling regime, resolved by repro_torch.core.backends
    # .resolve_tiling: "oneshot" is the one-block-per-row kernels,
    # "tiled" the column-tiled selection and streamed exchange, "auto"
    # oneshot while the one-shot kernel's shared memory fits one H100
    # block, tiled beyond.
    selection_tiling: str = "auto"
    exchange_tiling: str = "auto"
    # reference-set regime (DESIGN.md §7): "personal" exchanges logits
    # on each client's own X_i^ref (M*N neighbor forwards via gathered
    # params — the paper's point-to-point protocol); "public" evaluates
    # ONE shared reference set (the abstract's public reference dataset)
    # so the exchange needs only M forwards and a logit gather.
    ref_mode: str = "personal"
    # Eq. 7 ranking-score dedupe (DESIGN.md §7 caveat): collapse
    # duplicate revealed ranking vectors to one vote before scoring.
    # Off by default (the paper's literal Eq. 7); the launchers set it
    # from `recommended_dedupe(ref_mode)` — on under "public", where
    # every selector sees the same l_ij for a neighbor and Eq. 7
    # otherwise aggregates duplicated evidence.
    dedupe_rankings: bool = False
    # verification toggles (ablations / attack studies)
    use_lsh: bool = True           # w/o LSH ablation
    use_rank: bool = True          # w/o Rank ablation
    lsh_verification: bool = True  # §3.5 output-KL lower-half filter
    rank_verification: bool = True # §3.6 commit-and-reveal


def recommended_dedupe(ref_mode: str) -> bool:
    """The Eq. 7 dedupe setting launchers apply per reference regime
    (DESIGN.md §10, one place): under "public" every selector sees the
    same l_ij for a neighbor, so duplicate revealed rankings carry no
    independent evidence and dedupe is on; "personal" keeps the
    paper's literal Eq. 7 (and the legacy bit-exactness pins)."""
    return ref_mode == "public"


PAPER_FED_OPTIMA = {
    # dataset -> (N, alpha, gamma)  — paper Table 1
    "mnist": (12, 0.6, 1.0),
    "aecg": (10, 0.6, 1.0),
    "seeg": (8, 0.6, 1.0),
}

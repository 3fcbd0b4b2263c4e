"""Work counted from shapes: the round's model FLOPs and the Eq. 5
projection's least time, with the chip's published peaks.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 67 TFLOP/s f32 outside the tensor cores, 495 TF32, 989 bf16,
3.35 TB/s HBM3. The port runs its clients in f32 with TF32 off
(`repro_torch/device.py`), so f32 is the peak that applies.

The model FLOPs are counted as `repro_torch/launch/dryrun.py` counts
them: `torch.utils.flop_counter.FlopCounterMode` on meta tensors, at
the cell's shapes, here over the reference's client models (their
convolutions are im2col products, which count as the convolutions'
multiply-adds). A round's parts: the local update (M clients x
local_steps steps: forward on the minibatch and on the reference set,
backward), the clients' own reference forwards (M x R) and, in
personal mode, the neighbour web (M x N x R forwards). The count is
frozen in `cells/<cell>.json`; a CPU test recounts it.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench import inputs
from portbench.reference import models

PEAKS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def count(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """{"update", "own", "web", "total"} FLOPs of one round."""
    from torch.utils.flop_counter import FlopCounterMode
    model, proto, data = cfg["model"], cfg["protocol"], cfg["data"]
    kind, m = model["kind"], traffic["clients"]
    n = min(proto["num_neighbors"], m - 1)
    r = data["ref_per_client"]
    feat = tuple(model["input_shape"])
    params = {k: _meta((1,) + s) for k, s in inputs.param_shapes(model)}
    with FlopCounterMode(display=False) as fwd:
        models.forward(kind, params, _meta((1, r) + feat))
    mb = proto["local_batch"]
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    with FlopCounterMode(display=False) as step:
        logits = models.forward(kind, leaves, _meta((1, mb) + feat))
        own = models.forward(kind, leaves, _meta((1, r) + feat))
        loss = torch.log_softmax(logits, -1).mean() + (own * own).mean()
        torch.autograd.grad(loss, list(leaves.values()))
    per_fwd, per_step = fwd.get_total_flops(), step.get_total_flops()
    parts = {"update": m * proto["local_steps"] * per_step,
             "own": m * per_fwd,
             "web": m * n * per_fwd if traffic["ref_mode"] == "personal"
             else 0}
    return {**parts, "total": sum(parts.values())}


def announce_least_s(cfg: Dict, traffic: Dict) -> float:
    """The Eq. 5 projection of M parameter vectors of P onto `bits`
    signs at the chip's peaks: the larger of 2 M P bits over the f32
    rate and the M P f32 parameters read once over HBM bandwidth."""
    m, p = traffic["clients"], inputs.param_count(cfg["model"])
    bits = cfg["protocol"]["lsh_bits"]
    return max(2.0 * m * p * bits / PEAKS["f32"], 4.0 * m * p / PEAKS["hbm"])

"""Seeded-leak fixture: `taint-sink` — a serving response derived from a
PRIVATE TRAINING BATCH, not just the requested model's logits on the
request input: the served output mixes in the mean of the client's
local data, so the response sink receives client-data. Twin of
`tests/analysis_fixtures/leak_served_private.py`."""
import torch

from repro_torch.analysis.privacy import sink
from repro_torch.analysis.taint import SRC_DATA, taint_target


def leaky_serve(x_request, x_train):
    # BUG: the response blends in statistics of the private batch
    out = x_request * 2.0 + x_train.mean()
    return sink("serving-response", out)


taint_target(
    name="leak-served-private",
    build=lambda: (leaky_serve,
                   (torch.ones((2, 8), dtype=torch.float32),
                    torch.ones((16, 8), dtype=torch.float32)),
                   ("", SRC_DATA)))

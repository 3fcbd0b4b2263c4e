"""Runs the check must refuse: the program in a lower precision, and
the program with a fault planted under the timed path."""
import json
from pathlib import Path

import pytest
import torch

from portbench import faults
from portbench.test_portbench_reference import cpu_run

PROTO = json.loads((Path(__file__).resolve().parent / "configs"
                    / "wpfed-aecg-tcn.json").read_text())["protocol"]


def test_lowered_precision_is_refused():
    """The control: every convolution and matrix product reads its inputs
    in TF32 (on the CPU too, where no TF32 kernel exists)."""
    res = cpu_run("aecg-personal-4k", tf32=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_faults_are_refused(fault):
    res = cpu_run("aecg-personal-4k", wrap=faults.FAULTS[fault](PROTO))
    assert not res["correct"], res["checks"]


def from_round(first, fault):
    """`fault` on the rounds from `first` on: the window's alone."""
    def fn(round_fn, state, *a, **k):
        if state.round >= first:
            return fault(round_fn, state, *a, **k)
        return round_fn(state, *a, **k)
    return fn


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_in_the_window_alone_are_refused(fault):
    """The check replays the window's last period too: a fault that
    starts after set-up's checked rounds (2 here) is caught."""
    inner = {"unchanged": faults.unchanged,
             "half_batch": faults.half_batch(PROTO["local_steps"],
                                             PROTO["local_batch"])}[fault]
    res = cpu_run("aecg-personal-4k",
                  wrap=faults.wrap_rounds(from_round(2, inner)))
    assert not res["correct"], res["checks"]
    assert res["checks"]["update_gap"][0] > \
        res["checks"]["update_gap"][1], res["checks"]


@pytest.mark.cuda
def test_tf32_control_is_refused_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from portbench import cells, harness
    cell = cells.load_cell("aecg-personal-4k")
    opts = harness.Options(device="cuda", tf32=True,
                           traffic={"clients": 256})
    res = harness.execute(cell, 2 ** 31 + 5, 0.0, False, opts,
                          log=lambda s: None)
    assert not res["correct"], res["checks"]

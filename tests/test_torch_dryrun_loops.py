"""The LM dry run's time loops (`repro_torch.launch.dryrun`): the sLSTM
step loop and the mLSTM chunk loop counted from one and two trips
(`models.xlstm.cut_loops`) and rebuilt, against the step-by-step count.

Counts are FlopCounterMode integers on meta and compared exactly. The
mLSTM chunk is cut to 8 positions here (`MLSTM_CHUNK`, read at each
call), so a 24-token sequence has 3 chunks and 24 sLSTM steps; the
reduced xlstm runs at 4 layers (2 repetitions of ("S", "M")) and 5 (a
tail "S" layer too), so the repetition rebuild and the tail are both
exercised. Every other arch's count is the repetition rebuild alone, as
before the loops were rebuilt.
"""
import dataclasses

import pytest
import torch

from torch_threads import intra_op_threads  # noqa: F401 (autouse)

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import xlstm

SEQ, CHUNK = 24, 8


@pytest.fixture
def short_chunks(monkeypatch):
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", CHUNK)


@pytest.mark.parametrize("mode,layers", [("train", 4), ("prefill", 5)])
def test_rebuilt_loops_equal_step_by_step(short_chunks, mode, layers):
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(),
                              num_layers=layers)
    shape = ShapeConfig("short", SEQ, 2, mode)
    got = dryrun.counted_flops(cfg, shape)
    assert got["loop_trips"] == {"slstm": SEQ, "mlstm": SEQ // CHUNK}
    assert got["counted_trips"] == [1, 2] and got["counted_reps"] == [1, 2]
    assert got["flops"] == float(dryrun.step_flops(cfg, shape))


def test_decode_has_no_time_loop():
    cfg = get_config("xlstm-350m").reduced()
    assert dryrun.loop_trips(cfg, ShapeConfig("d", SEQ, 2, "decode")) == {}
    hybrid = get_config("recurrentgemma-2b").reduced()
    assert dryrun.loop_trips(hybrid, ShapeConfig("t", SEQ, 2, "train")) == {}


def _by_reps(cfg, shape):
    """The count before the loops were rebuilt: base + reps * body."""
    if cfg.pattern_reps < 2:
        return float(dryrun.step_flops(cfg, shape))
    one = dryrun.step_flops(dryrun._with_reps(cfg, 1), shape)
    two = dryrun.step_flops(dryrun._with_reps(cfg, 2), shape)
    return float(one + (cfg.pattern_reps - 1) * (two - one))


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if a != "xlstm-350m"])
def test_other_archs_count_as_before(arch):
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(                 # 2 repetitions and a tail
        cfg, num_layers=2 * len(cfg.block_pattern) + 1)
    shape = ShapeConfig("short", 64, 2, "train")
    got = dryrun.counted_flops(cfg, shape)
    assert "loop_trips" not in got
    assert got["flops"] == _by_reps(cfg, shape)


def test_cut_loops_leave_real_tensors_alone():
    """On CPU tensors the cut changes nothing: every step runs."""
    cfg = get_config("xlstm-350m").reduced()
    g = torch.Generator().manual_seed(0)
    from repro_torch.models.transformer import init_params
    p = init_params(cfg, g)["layers"]
    x = torch.randn((1, 6, cfg.d_model), generator=g)
    s_rec = {k: v[0] for k, v in p[0]["rec"].items()}
    m_rec = {k: v[0] for k, v in p[1]["rec"].items()}
    want = (xlstm.slstm_forward(cfg, s_rec, x)[0],
            xlstm.mlstm_forward(cfg, m_rec, x)[0])
    with xlstm.cut_loops(slstm=1, mlstm=1):
        got = (xlstm.slstm_forward(cfg, s_rec, x)[0],
               xlstm.mlstm_forward(cfg, m_rec, x)[0])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert xlstm._CUT == {"slstm": None, "mlstm": None}

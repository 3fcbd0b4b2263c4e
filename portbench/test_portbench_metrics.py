"""Each per-layer reader on a small recorded trace (Chrome trace events
as `torch.profiler` writes them)."""
from types import SimpleNamespace

import pytest

from portbench import cells, flops
from portbench.trace import Trace


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def recorded():
    """Two rounds of 100 us. Round 1: select launches k0 (runs 5-10),
    exchange launches k1 (runs 30-50), update launches k2 and a memcpy
    (run 55-80 and 80-85), announce launches k3 (runs 90-95). Round 2 is
    a gossip epoch: exchange k4 (130-150), update k5 (150-190), and the
    harness's publish at 195-200. k2 starts after its span ended: it is
    the update's all the same, by its launch."""
    return [
        ev("user_annotation", "portbench.stretch", 0, 200),
        ev("user_annotation", "wpfed.select", 0, 20),
        ev("user_annotation", "wpfed.exchange", 20, 20),
        ev("user_annotation", "wpfed.update", 40, 10),
        ev("user_annotation", "wpfed.announce", 85, 10),
        ev("user_annotation", "wpfed.exchange", 120, 10),
        ev("user_annotation", "wpfed.update", 130, 20),
        ev("user_annotation", "portbench.publish", 195, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 1, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 1, 3),
        ev("cuda_runtime", "cudaMemcpyAsync", 46, 1, 4),
        ev("cuda_driver", "cuLaunchKernel", 86, 1, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 121, 1, 6),
        ev("cuda_runtime", "cudaLaunchKernel", 131, 1, 7),
        ev("kernel", "k0", 5, 5, 1),
        ev("kernel", "k1", 30, 20, 2),
        ev("kernel", "k2", 55, 25, 3),
        ev("gpu_memcpy", "Memcpy DtoD", 80, 5, 4),
        ev("kernel", "k3", 90, 5, 5),
        ev("kernel", "k4", 130, 20, 6),
        ev("kernel", "k5", 150, 40, 7),
    ]


@pytest.fixture
def ctx():
    cfg = {"model": {"kind": "tcn", "input_shape": [60, 1], "num_classes": 2,
                     "hidden": [32, 32, 32], "kernel_size": 5},
           "protocol": {"lsh_bits": 256}}
    traffic = {"clients": 4096}
    return SimpleNamespace(
        trace=Trace(recorded()), rounds=2, global_rounds=1, round_s=1e-4,
        flops_per_round=1.34e9, peaks=flops.PEAKS,
        announce_least_s=flops.announce_least_s(cfg, traffic))


def read(name, ctx):
    return cells.metric_reader(name)(ctx)


def test_attribution_follows_the_launch(ctx):
    by = ctx.trace.by_phase()
    assert by == {"wpfed.select": 5, "wpfed.exchange": 40,
                  "wpfed.update": 70, "wpfed.announce": 5}


def test_readers(ctx):
    assert read("launches_per_round", ctx) == 3.5
    assert read("update_ms", ctx) == pytest.approx(0.035)
    assert read("exchange_ms", ctx) == pytest.approx(0.020)
    assert read("reselect_ms", ctx) == pytest.approx(0.010)
    least = ctx.announce_least_s
    assert least == pytest.approx(2 * 4096 * 10594 * 256 / 67e12)
    assert read("announce_roofline", ctx) == pytest.approx(
        100 * least / 5e-6)
    assert read("round_mfu", ctx) == pytest.approx(
        100 * 1.34e9 / (1e-4 * 67e12))
    # busy: 5-10, 30-95 (30-50, 55-80, 80-85, 90-95 with gaps), 130-190
    busy = 5 + 20 + 25 + 5 + 5 + 60
    assert ctx.trace.busy_us() == busy
    assert read("idle_share", ctx) == pytest.approx(100 * (1 - busy / 200))


def test_idle_gaps_name_the_host_span(ctx):
    # idle 95-130 begins in the announce span, 10-30 in select, 190-200
    # in no phase span
    gaps = [(n, round(s * 1e6)) for n, s in ctx.trace.idle_gaps()]
    assert gaps[:3] == [("wpfed.announce", 35), ("wpfed.select", 20),
                        ("other", 10)]
    names = [n for n, _ in ctx.trace.top_ops()]
    assert names[0] == "k5"


def test_readers_find_nothing_in_an_empty_trace():
    empty = SimpleNamespace(trace=Trace([]), rounds=2, global_rounds=1,
                            round_s=None, flops_per_round=None,
                            peaks=flops.PEAKS, announce_least_s=1e-3)
    for name in ("launches_per_round", "update_ms", "exchange_ms",
                 "reselect_ms", "announce_roofline", "round_mfu",
                 "idle_share"):
        assert read(name, empty) is None

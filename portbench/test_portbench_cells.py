"""The harness is driven by data: a new traffic mix, cell or metric is a
new file found by name; the benchmark file keeps the contract's shape;
the frozen FLOP counts are what the shapes give."""
import json
import re
from pathlib import Path

import pytest

from portbench import cells, flops

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "bench"
    for sub in ("traffic", "cells", "metrics"):
        (base / sub).mkdir(parents=True)
    traffic = json.loads((HERE / "traffic" / "personal-1k.json").read_text())
    traffic["clients"] = 2048
    (base / "traffic" / "personal-2k.json").write_text(json.dumps(traffic))
    (base / "cells" / "mnist-personal-2k.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5}}))
    (base / "metrics" / "rounds_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.rounds)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mnist-personal-2k",
                               "config": "wpfed-mnist-cnn",
                               "traffic": "personal-2k", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "count",
                               "better": "higher", "source": "device_trace",
                               "layer": "round engine", "moves": "round_s"})
    cell = cells.load_cell("mnist-personal-2k", bench=bench, base=base)
    assert cell["traffic_data"]["clients"] == 2048
    assert cell["cell_data"]["limits"]["loss_gap"] == 0.5
    assert "rounds_seen" in cell["per_layer"]
    reader = cells.metric_reader("rounds_seen", base)
    assert reader(type("Ctx", (), {"rounds": 3})) == 3.0
    other = cells.load_cell(BENCH["workloads"][0]["name"], bench=bench)
    assert "rounds_seen" in other["per_layer"]      # every metric, every cell


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert (HERE.parent / c["file"]).exists()
        assert json.loads((HERE.parent / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "cells" / f"{w['name']}.json").exists()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] == "round_s"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_frozen_flops_match_the_shapes(cell):
    c = cells.load_cell(cell)
    assert c["cell_data"]["flops"] == flops.count(c["config_data"],
                                                  c["traffic_data"])

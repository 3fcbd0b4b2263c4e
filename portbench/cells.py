"""Find a cell and everything it names, by name, from files of their own:
`BENCHMARK.json` at the root of the checkout, the configuration file it
names, `traffic/<traffic>.json`, `cells/<cell>.json` (the frozen FLOP
count and the check's limits) and `metrics/<metric>.py` (a reader with
`read(ctx) -> float | None`). A new cell, configuration, traffic mix or
metric is a new file and a new entry; no code here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_cell(name: str, bench: Dict = None, root: Path = ROOT,
              base: Path = HERE) -> Dict:
    """The workload `name` of BENCHMARK.json (or of `bench`) with its
    configuration (its `file`, under `root`), traffic and cell data
    (under `base`) and the benchmark's metrics."""
    bench = bench if bench is not None else _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    cell_file = base / "cells" / f"{name}.json"
    return {
        "name": name, "workload": w, "base": base, "chips": w["chips"],
        "config_data": _load_json(root / conf["file"]),
        "traffic_data": _load_json(base / "traffic" / f"{w['traffic']}.json"),
        "cell_data": _load_json(cell_file) if cell_file.exists() else {},
        "end_to_end": {m["name"]: m for m in bench["end_to_end"]},
        "per_layer": {m["name"]: m for m in bench["per_layer"]},
    }


def metric_reader(name: str, base: Path = HERE) -> Callable:
    """`read` of metrics/<name>.py under `base`."""
    path = Path(base) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

#!/usr/bin/env python3
"""Time the federation's client-axis paths of one checkout on a CUDA card.

    python3 scripts/torch_client_axis_ab.py [--root DIR] [--label NAME]
                                            [--phase] [--out FILE]

Loads `repro_torch` and `chip_smoke.py` from DIR (default: this
checkout), builds its kernels there, and measures, with that checkout's
own code:

* `mnist`: the paper's mnist federation (10 CNN clients, one-shot
  kernels), round 1 profiled (`chip_smoke.profile_round`: wall seconds,
  device idle share, host ms per phase span, device ms per phase), and
  the seconds of rounds 1-2 of a 3-round run (round 0 warms the
  process);
* `fed_dryrun`: the federation dry run (`launch/fed.py`:
  `prepare_fed_dryrun`, `run_fed_dryrun` with one warm-up segment) at
  256 personal clients and at 1,024 public tiled clients: the first
  segment's seconds (`warmup_s`), the warmed period (`wall_s`), the
  peak and temp bytes, the flash launches of the timed segment;
* with `--phase`: the checkout's whole `fed_dryrun` phase of
  `chip_smoke.py` (`fed_dryrun_path`, with its own checks), timed.

Prints the card's name and power limit, then one JSON line per part;
`--out` appends the lines to FILE too. To compare two checkouts on one
card, run it in turns in one command (parent, change, change, parent),
with the parent unpacked by `git archive` into a gitignored directory.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DRYRUNS = (("256_personal", dict(num_clients=256)),
           ("1024_public_tiled", dict(num_clients=1024, ref_mode="public",
                                      tiling="tiled")))


def load_chip_smoke(root: Path):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_root", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--phase", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_client_axis_ab: no CUDA device available",
              file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    cs = load_chip_smoke(root)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, flash_attention
    from repro_torch.launch.fed import (prepare_fed_dryrun, run_federation,
                                        run_fed_dryrun)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def emit(obj):
        line = json.dumps({"label": args.label, "root": str(root),
                           "card": smi, **obj})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    resolve_device("cuda")
    kernels = cs.kernel_objects()
    t0 = time.perf_counter()
    build.build_all(kernels.values())
    emit({"part": "build", "seconds": time.perf_counter() - t0})

    _, hist = run_federation("mnist", rounds=3, device="cuda", log=None)
    names = (*cs.LSH_NAMES, "fused_select_kernel", "fused_exchange_kernel")
    prof = cs.profile_round(run_federation, names, tiling="oneshot",
                            backend="kernel")
    emit({"part": "mnist", "round_s": [h["seconds"] for h in hist[1:]],
          "acc": [h["acc"] for h in hist], **prof})

    for label, kw in DRYRUNS:
        torch.cuda.empty_cache()
        dr = prepare_fed_dryrun(**kw)
        n0 = flash_attention.KERNEL.launches
        report, _ = run_fed_dryrun(dr, warmup=1, log=None)
        emit({"part": "fed_dryrun", "run": label,
              "warmup_s": report["warmup_s"], "wall_s": report["wall_s"],
              "peak_gb": (report["peak_bytes"] or 0) / 1e9,
              "temp_gb": (report["temp_bytes"] or 0) / 1e9,
              "flash_launches_both_segments":
                  flash_attention.KERNEL.launches - n0})
        del dr, report

    if args.phase:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = cs.fed_dryrun_path(torch, kernels)
        emit({"part": "fed_dryrun_phase",
              "seconds": time.perf_counter() - t0,
              "period_s": {k: v["wall_s"] for k, v in out.items()},
              "peak_gb": {k: v["peak_bytes"] / 1e9 for k, v in out.items()},
              "unit_busy_ms": out["default"].get("unit_busy_ms"),
              "idle_share_estimate": out["default"].get(
                  "device_idle_share_estimate")})
    return 0


if __name__ == "__main__":
    sys.exit(main())

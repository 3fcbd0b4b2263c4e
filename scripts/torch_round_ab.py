#!/usr/bin/env python3
"""Time the port's mnist round (the main path) of one checkout.

    python3 scripts/torch_round_ab.py --root <checkout> --label parent

Imports `repro_torch` from `<checkout>/src` (default: this repository),
runs `run_federation("mnist", rounds=R, backend="kernel")` once to build
the kernels and warm up, then `--repeats` times more, and prints one JSON
line: the label, the card (`nvidia-smi` name and power limit), each
timed run's round seconds, and the median over the timed runs of rounds
>= 1. To compare two checkouts on one card, run parent, change, change,
parent in one command. `--device cpu` rehearses the script without a
card (its times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    from repro_torch.launch.fed import run_federation
    backend = "kernel"
    card = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_round_ab: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        backend = "oracle"
    kw = dict(rounds=args.rounds, backend=backend, device=args.device,
              log=None)
    run_federation("mnist", **kw)                     # build and warm up
    runs = [[h["seconds"] for h in run_federation("mnist", **kw)[1]]
            for _ in range(args.repeats)]
    print(json.dumps({
        "label": args.label, "root": args.root, "card": card,
        "round_seconds": runs,
        "median_round_s": statistics.median(s for r in runs for s in r[1:])}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

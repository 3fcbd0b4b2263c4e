#!/usr/bin/env python3
"""Time the port's two LSH projection kernels of one checkout on a CUDA card.

    python3 scripts/torch_lsh_ab.py [--root DIR] [--label NAME]
                                    [--save FILE] [--against FILE]

Loads `repro_torch` from DIR/src (default: this checkout), builds its
LSH kernels there, and times `lsh_project_sums_batched` and
`lsh_project_sums` at every LSH shape that `chip_smoke.py` checks, with
`chip_smoke.py`'s own timing helpers: the kernels' device time per call
(torch.profiler, per-name medians), the CUDA-event time of one wrapper
call, and `torch.matmul(x, R)` with R materialised. Prints the card's
name and power limit, then one JSON line per shape. The inputs come from
one seeded generator, so every checkout sees the same x; `--save` keeps
the sums of every shape in FILE, and `--against` prints per shape
whether they equal those saved by another checkout bit for bit.

To compare two versions of the kernels on one card, run it in turns on
both checkouts in one command (parent, change, change, parent), e.g.
with the parent unpacked by `git archive` into a gitignored directory.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BATCHED = ((10, 421_888), (16, 4096), (256, 421_888), (35, 12_288),
           (4096, 12_288))
SINGLE = (421_888, 4096, 8192, 12_288)
NAMES = ("lsh_partial", "lsh_reduce")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_lsh_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import chip_smoke
    from repro_torch.kernels import lsh_projection, ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [("batched", m, p) for m, p in BATCHED] + \
        [("single", 1, p) for p in SINGLE]
    saved = {}
    other = torch.load(args.against) if args.against else {}
    for kind, m, p in cases:
        shape = (m, p) if kind == "batched" else (p,)
        x = torch.randn(shape, generator=gen, device="cuda") * 0.05
        r = ops.rademacher_block(0, p, 256, 7, device="cuda")
        fn = (lsh_projection.lsh_project_sums_batched if kind == "batched"
              else lsh_projection.lsh_project_sums)
        out = {"label": args.label, "kind": kind, "m": m, "p": p,
               "bits": 256,
               "kernel_ms": chip_smoke.device_ms(
                   lambda: fn(x, 7, bits=256), NAMES),
               "call_ms": chip_smoke.time_ms(lambda: fn(x, 7, bits=256)),
               "library_ms": chip_smoke.library_device_ms(
                   lambda: torch.matmul(x, r))}
        key = f"{kind}-{m}-{p}"
        saved[key] = fn(x, 7, bits=256).cpu()
        if key in other:
            out["bit_equal_to_against"] = bool(torch.equal(saved[key],
                                                           other[key]))
        print(json.dumps(out), flush=True)
        del x, r
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())

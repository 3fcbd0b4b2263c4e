#!/usr/bin/env python3
"""Measure how far the single-client LSH kernel's sums drift from an
exact sum on one shard of a long parameter vector, on a CUDA card.

    python3 scripts/torch_lsh_drift.py [--root DIR] [--label NAME]
                                       [--rank R] [--world W]

Loads `repro_torch` from DIR/src (default: this checkout) and builds its
LSH kernels there. The vector is `chip_smoke.py`'s sharding input:
Minitron-4B's 4,190,309,376 parameters padded to a CHUNK multiple,
hashed from seed 11 by global index; rank R of W makes only its shard
and pads it as `sharded_lsh_code` does. Then on that shard, at its
global row offset:
* `lsh_project_sums` on the whole shard (one launch);
* the same kernel on slices of 2^24 entries at their own offsets, the
  slices' sums added in f64;
* the plain version, `ref.lsh_project_sums_ref`;
* the exact sum: each BLOCK_P block of R times x in f64, added in f64.
Prints the card's name and power limit, then one JSON line: each
result's max |difference| from the exact sum over the bits, the largest
|sum|, and the seconds of each part. To compare two versions of the
kernel, run it on both checkouts in one command. Exits 1 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SLICE = 1 << 24
SEED, BITS = 11, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--rank", type=int, default=3)
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_lsh_drift: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, lsh_projection, ops, ref
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    resolve_device("cuda")
    build.build_all([lsh_projection.SINGLE_KERNEL])

    p_pad = -(-chip_smoke.MINITRON_PARAMS // ops.CHUNK) * ops.CHUNK
    n = p_pad // args.world
    off = args.rank * n
    shard = torch.empty(n, device="cuda")
    chip_smoke.fill_by_index(torch, shard, off, chip_smoke.MINITRON_PARAMS,
                             SEED)
    x = F.pad(shard, (0, (-n) % ops.CHUNK))
    del shard
    p = x.numel()
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def slices():
        s = torch.zeros(BITS, dtype=torch.float64, device="cuda")
        for a in range(0, p, SLICE):
            s += lsh_projection.lsh_project_sums(
                x[a:a + SLICE], SEED, bits=BITS, row_offset=off + a).double()
        return s

    def exact():
        s = torch.zeros(BITS, dtype=torch.float64, device="cuda")
        for a in range(0, p, ref.BLOCK_P):
            b = min(a + ref.BLOCK_P, p)
            r = ops.rademacher_block(off + a, b - a, BITS, SEED,
                                     device="cuda")
            s += x[a:b].double() @ r.double()
        return s

    whole = timed("kernel", lambda: lsh_projection.lsh_project_sums(
        x, SEED, bits=BITS, row_offset=off))
    sliced = timed("kernel_slices", slices)
    plain = timed("plain", lambda: ref.lsh_project_sums_ref(
        x, SEED, bits=BITS, row_offset=off))
    want = timed("exact_f64", exact)

    def drift(v):
        return (v.double() - want).abs().max().item()

    print(json.dumps({
        "label": args.label, "rank": args.rank, "world": args.world,
        "row_offset": off, "p": p, "splits": p // lsh_projection.split_len(p),
        "max_abs_sum": want.abs().max().item(),
        "x_norm": x.double().norm().item(),
        "kernel_drift": drift(whole), "kernel_slices_drift": drift(sliced),
        "plain_drift": drift(plain),
        "kernel_vs_plain": (whole - plain).abs().max().item(),
        "seconds": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's two exact selection kernels of one checkout on a CUDA
card.

    python3 scripts/torch_selection_ab.py [--root DIR] [--label NAME]
                                          [--save FILE] [--against FILE]

Loads `repro_torch` from DIR/src (default: this checkout), builds its
selection kernels there, and times `fused_select` at (M, bits, N) =
(10, 256, 9), (1,024, 256, 16), (4,096, 256, 16), (16,384, 256, 16) and
(46,489, 256, 16), and `fused_select_tiled` at (10, 256, 9),
(1,024, 256, 16), (2,048, 256, 16), (4,096, 512, 16) and
(65,536, 256, 16), with `chip_smoke.py`'s own helpers: the kernel's
device time per call (torch.profiler, per-name medians) and the
CUDA-event time of one wrapper call. Prints the card's name and power
limit, then one JSON line per shape with the launch plan where the
checkout has one (`selection.select_plan`). The inputs come from one
seeded generator, so every checkout sees the same codes and scores. Each
line says whether ids and weights equal the checkout's plain version
bit for bit (`plain_equal`; `fused_select_ref`, or past M = 8,192
`fused_select_tiled_ref` in 4096 x 4096 tiles); a launch the checkout
refuses prints its error instead. `--save` keeps every
shape's outputs in FILE, and `--against` prints per shape whether they
equal bit for bit those saved by another checkout (`bit_equal`).

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
ONESHOT = ((10, 256, 9), (1024, 256, 16), (4096, 256, 16),
           (16_384, 256, 16), (46_489, 256, 16))
TILED = ((10, 256, 9), (1024, 256, 16), (2048, 256, 16), (4096, 512, 16),
         (65_536, 256, 16))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_selection_ab: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import chip_smoke
    from repro_torch.kernels import ref, selection
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    plan = getattr(selection, "select_plan", None)
    saved = {}
    other = torch.load(args.against) if args.against else {}
    cases = [("oneshot", s) for s in ONESHOT] + \
        [("tiled", s) for s in TILED]
    for kind, (m, bits, n) in cases:
        codes, scores = chip_smoke.selection_inputs(torch, m, bits, gen,
                                                    ties=False)
        wrapper, name = ((selection.fused_select, "fused_select_kernel")
                         if kind == "oneshot" else
                         (selection.fused_select_tiled,
                          "select_tiled_kernel"))
        fn = lambda: wrapper(codes, scores, bits=bits,  # noqa: E731
                             gamma=1.0, num_neighbors=n)
        lut = ref.selection_lut(bits // 32, bits, 1.0, device="cuda")
        head = {"label": args.label, "kernel": kind, "m": m, "bits": bits,
                "n": n, "plan": plan(m, bits // 32, n) if plan else None}
        try:
            got = fn()
        except RuntimeError as e:       # a launch the checkout refuses
            print(json.dumps({**head, "error": str(e)}), flush=True)
            continue
        want = chip_smoke.selection_plain(ref, codes, scores, lut, n)()
        out = {**head, "kernel_ms": chip_smoke.device_ms(fn, (name,)),
               "call_ms": chip_smoke.time_ms(fn),
               "plain_equal": bool(torch.equal(got[0], want[0])
                                   and torch.equal(got[1], want[1]))}
        key = f"{kind}-{m}-{bits}-{n}"
        if key in other:
            out["bit_equal"] = all(bool(torch.equal(a, b.to(a.device)))
                                   for a, b in zip(got, other[key]))
        print(json.dumps(out), flush=True)
        if args.save:
            saved[key] = tuple(a.cpu() for a in got)
        del codes, scores, got, want
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())

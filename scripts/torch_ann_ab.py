#!/usr/bin/env python3
"""Time the ANN selection route of one checkout on a CUDA card.

    python3 scripts/torch_ann_ab.py [--root DIR] [--label NAME]
                                    [--save FILE] [--against FILE]
                                    [--per-row [--rows R,R,...]]

Loads `repro_torch` from DIR/src (default: this checkout), builds its
selection kernels there, and times its ANN route at (M, bits, N, codes,
prefix bits, probes) = (10, 256, 9, random, 10, 8) (K = 100, the main
path's), (4,096, 256, 16, clustered, 10, 8) (K = 185), (4,096, 256, 16,
random, 0, 0) (K = 4,128, one bucket) and (65,536, 256, 16, clustered,
10, 8) (K = 2,336): the route's candidate generation (`call` ms: CUDA
events around one call; `device` ms: its device work per call, from
torch.profiler), its kernel (device ms, per-name medians), and one whole
`select_partners(backend="ann")` (CUDA events), with `chip_smoke.py`'s
own helpers. The route is the checkout's own: `ann.bucket_candidates`
and `fused_select_ann_grouped` where it has them, else `ann_candidates`
and the per-row `fused_select_ann`. Prints the card's name and power
limit, then one JSON line per shape. The inputs come from one seeded
generator, so every checkout sees the same codes and scores. Each line
says whether the route's ids equal `ann_select_ref` on `ann_candidates`
of the same codes (`plain_equal`); `--save` keeps every shape's ids and
weights in FILE, and `--against` prints per shape whether they equal bit
for bit those saved by another checkout (`bit_equal`).

`--per-row` times the per-row function instead: `fused_select_ann` on
`ann_candidates` (`chip_smoke.ann_inputs`, the draws of
`chip_smoke.py`'s five per-row checks) at (M, bits, N, codes, prefix
bits, probes) = (10, 256, 9, random, 10, 8), (10, 256, 9, ties, 10, 8),
(4,096, 256, 16, clustered, 10, 8), (65,536, 256, 16, clustered, 10,
8) and (4,096, 256, 16, random, 0, 0), its device ms under the name of
the kernel it launches in that checkout (`select_ann_rows_kernel`, the
grouped entry point's one-row instance, where the checkout has
`ann_plan(one_row_slots=)`, else the per-row `select_ann_kernel`), with
`plain_equal` against `ann_select_ref` and the plan where there is one;
`--rows` there also times the one-row instance at each of these clients
a CTA (`selection.ONE_SLOT_ROWS` set for the timing, every output held
bit-equal to the plan's).

To compare the parent's route with the change's on one card, run it in
turns on both checkouts in one command (parent, change, change, parent),
e.g. with the parent unpacked by `git archive` into a gitignored
directory. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((10, 256, 9, "random", 10, 8), (4096, 256, 16, "clustered", 10, 8),
          (4096, 256, 16, "random", 0, 0),
          (65_536, 256, 16, "clustered", 10, 8))
PER_ROW_SHAPES = ((10, 256, 9, "random", 10, 8), (10, 256, 9, "ties", 10, 8),
                  (4096, 256, 16, "clustered", 10, 8),
                  (65_536, 256, 16, "clustered", 10, 8),
                  (4096, 256, 16, "random", 0, 0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    ap.add_argument("--per-row", action="store_true")
    ap.add_argument("--rows", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ann_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import chip_smoke
    from repro_torch.configs.paper_models import FedConfig
    from repro_torch.core import ann
    from repro_torch.core.neighbor import select_partners
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ref, selection
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    grouped = hasattr(ann, "bucket_candidates")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    saved = {}
    other = torch.load(args.against) if args.against else {}
    if args.per_row:
        per_row(torch, args, chip_smoke, ref, selection, gen, saved, other)
        if args.save:
            torch.save(saved, args.save)
        return 0
    for m, bits, n, kind, pb, probes in SHAPES:
        if kind == "clustered":
            codes, scores = chip_smoke.clustered_codes(torch, m, bits, gen)
        else:
            codes, scores = chip_smoke.selection_inputs(torch, m, bits, gen,
                                                        ties=False)
        fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits,
                        ann_prefix_bits=pb, ann_probes=probes)
        knobs = dict(seed=0, prefix_bits=pb, probes=probes, num_neighbors=n)
        kw = dict(bits=bits, gamma=fed.gamma, num_neighbors=n)
        if grouped:
            make = lambda: ann.bucket_candidates(  # noqa: E731
                codes, scores, **knobs)
            cand = make()
            kernel = lambda: selection.fused_select_ann_grouped(  # noqa: E731
                codes, scores, cand, **kw)
            name = "select_ann_grouped_kernel"
        else:
            make = lambda: ann.ann_candidates(    # noqa: E731
                codes, scores, **knobs)
            cand = make()
            kernel = lambda: selection.fused_select_ann(  # noqa: E731
                codes, scores, cand.ids, **kw)
            name = "select_ann_kernel"
        whole = lambda: select_partners(codes, scores, fed,  # noqa: E731
                                        backend="ann", seed=0)
        got = kernel()
        ids, _ = whole()
        rows = ann.ann_candidates(codes, scores, **knobs)
        lut = ref.selection_lut(bits // 32, bits, fed.gamma, device="cuda")
        want = ref.ann_select_ref(codes, scores, rows.ids, lut,
                                  num_neighbors=n)
        k = rows.ids.shape[1]
        del rows
        out = {"label": args.label, "route": "grouped" if grouped
               else "per_row", "m": m, "bits": bits, "n": n, "kind": kind,
               "prefix_bits": pb, "probes": probes, "k": k,
               "plain_equal": bool(torch.equal(got[0], want[0])
                                   and torch.equal(got[1], want[1])
                                   and torch.equal(ids, want[0])),
               "candidates_call_ms": chip_smoke.time_ms(make, iters=10),
               "candidates_device_ms": chip_smoke.device_ms(make, iters=5),
               "kernel_ms": chip_smoke.device_ms(kernel, (name,)),
               "select_partners_ms": chip_smoke.time_ms(whole, iters=10)}
        key = f"{m}-{bits}-{n}-{kind}-{pb}-{probes}"
        if key in other:
            out["bit_equal"] = all(bool(torch.equal(a, b.to(a.device)))
                                   for a, b in zip(got, other[key]))
        print(json.dumps(out), flush=True)
        if args.save:
            saved[key] = tuple(a.cpu() for a in got)
        del codes, scores, cand, got, want, ids
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    return 0


def per_row(torch, args, chip_smoke, ref, selection, gen, saved, other):
    """The `--per-row` mode: one JSON line per PER_ROW_SHAPES entry."""
    import inspect
    one_slot = "one_row_slots" in inspect.signature(
        selection.ann_plan).parameters
    name = "select_ann_rows_kernel" if one_slot else "select_ann_kernel"
    rows_sweep = [int(r) for r in args.rows.split(",") if r] \
        if one_slot else []
    for m, bits, n, kind, pb, probes in PER_ROW_SHAPES:
        codes, scores, cand = chip_smoke.ann_inputs(torch, m, bits, n, gen,
                                                    kind, pb, probes)
        kw = dict(bits=bits, gamma=1.0, num_neighbors=n)
        kernel = lambda: selection.fused_select_ann(  # noqa: E731
            codes, scores, cand.ids, **kw)
        got = kernel()
        lut = ref.selection_lut(bits // 32, bits, 1.0, device="cuda")
        want = ref.ann_select_ref(codes, scores, cand.ids, lut,
                                  num_neighbors=n)
        k = cand.ids.shape[1]
        out = {"label": args.label, "route": "per_row", "kernel": name,
               "m": m, "bits": bits, "n": n, "kind": kind,
               "prefix_bits": pb, "probes": probes, "k": k,
               "plan": selection.ann_plan(m, bits // 32, n, k, m,
                                          one_row_slots=True)
               if one_slot else None,
               "plain_equal": all(bool(torch.equal(a, b))
                                  for a, b in zip(got, want)),
               "kernel_ms": chip_smoke.device_ms(kernel, (name,))}
        if rows_sweep:
            default, out["rows_ms"] = selection.ONE_SLOT_ROWS, {}
            try:
                for r in rows_sweep:
                    selection.ONE_SLOT_ROWS = r
                    again = kernel()
                    out["rows_ms"][r] = {
                        "bit_equal": all(bool(torch.equal(a, b))
                                         for a, b in zip(again, got)),
                        "ms": chip_smoke.device_ms(kernel, (name,))}
            finally:
                selection.ONE_SLOT_ROWS = default
        key = f"per-row-{m}-{bits}-{n}-{kind}-{pb}-{probes}"
        if key in other:
            out["bit_equal"] = all(bool(torch.equal(a, b.to(a.device)))
                                   for a, b in zip(got, other[key]))
        print(json.dumps(out), flush=True)
        if args.save:
            saved[key] = tuple(a.cpu() for a in got)
        del codes, scores, cand, got, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's two exchange kernels of one checkout on a CUDA card.

    python3 scripts/torch_exchange_ab.py [--root DIR] [--label NAME]
                                         [--save FILE] [--against FILE]

Loads `repro_torch` from DIR/src (default: this checkout), builds its
exchange kernels there, and times `fused_exchange` and
`fused_exchange_streamed` at every exchange shape that `chip_smoke.py`
checks, with `chip_smoke.py`'s own timing helpers: the kernels' device
time per call (torch.profiler, per-name medians; the streamed kernel's
launches summed, and each alone) and the CUDA-event time of one wrapper
call.
Prints the card's name and power limit, then one JSON line per shape.
The inputs come from one seeded generator, so every checkout sees the
same logits. Each line says whether the outputs agree with the
checkout's plain version (`plain_*`): valid and has_target equal, l_ij
and target within the kernels' tolerances (one-shot rtol 1e-5, target
atol 1e-5; streamed rtol 2e-5, atol 1e-5). `--save` keeps every shape's
outputs in FILE, and `--against` prints per shape whether they agree
in the same sense with those saved by another checkout, and whether
they are equal bit for bit.

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
ONESHOT = ((10, 9, 64, 10), (8, 16, 64, 1024), (4096, 16, 64, 10),
           (65_536, 16, 64, 10))
STREAMED = ((10, 9, 64, 10), (8, 8, 32, 2048), (4, 16, 64, 1024),
            (4, 8, 16, 4096), (8, 8, 32, 100_352))
TOLERANCE = {"oneshot": (1e-5, 0.0, 1e-5), "streamed": (2e-5, 1e-5, 1e-5)}


def agree(torch, kind, got, other, prefix="") -> dict:
    """Masks equal, l_ij and target within the kernel's tolerance, and
    whether every output is equal bit for bit."""
    rtol, atol_l, atol_t = TOLERANCE[kind]
    kl, kv, kt, kh = got
    sl, sv, st, sh = (a.to(kl.device) for a in other)
    return {prefix + "masks_equal": bool(torch.equal(kv, sv)
                                         and torch.equal(kh, sh)),
            prefix + "close": bool(
                torch.allclose(kl, sl, rtol=rtol, atol=atol_l,
                               equal_nan=True)
                and torch.allclose(kt, st, rtol=rtol, atol=atol_t)),
            prefix + "bit_equal": all(
                bool(torch.equal(a, b)) for a, b in
                zip((kl.nan_to_num(), kv, kt, kh),
                    (sl.nan_to_num(), sv, st, sh)))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_exchange_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import chip_smoke
    from repro_torch.kernels import exchange, ref
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [("oneshot", s) for s in ONESHOT] + \
        [("streamed", s) for s in STREAMED]
    saved = {}
    other = torch.load(args.against) if args.against else {}
    for kind, (m, n, r, c) in cases:
        own, nb, y, sel = chip_smoke.exchange_inputs(torch, m, n, r, c, gen,
                                                     all_selected=False)
        if kind == "oneshot":
            fn = lambda: exchange.fused_exchange(own, nb, y, sel)  # noqa
            plain = ref.all_in_one_exchange_ref
            names = ("fused_exchange_kernel",)
        else:
            fn = lambda: exchange.fused_exchange_streamed(  # noqa
                own, nb, y, sel)
            plain = ref.streamed_exchange_ref
            names = chip_smoke.streamed_exchange_names(exchange, m, n, r, c)
        out = {"label": args.label, "kernel": kind, "m": m, "n": n, "r": r,
               "c": c, "kernel_ms": chip_smoke.device_ms(fn, names),
               "kernel_ms_by_name": {k: chip_smoke.device_ms(fn, (k,))
                                     for k in names},
               "call_ms": chip_smoke.time_ms(fn)}
        key = f"{kind}-{m}-{n}-{r}-{c}"
        got = fn()
        out.update(agree(torch, kind, got, plain(own, nb, y, sel), "plain_"))
        if key in other:
            out.update(agree(torch, kind, got, other[key]))
        print(json.dumps(out), flush=True)
        if args.save:
            saved[key] = tuple(a.cpu() for a in got)
        del own, nb, y, sel, got
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())

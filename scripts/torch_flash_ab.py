#!/usr/bin/env python3
"""Time the port's flash-attention kernel of one checkout on a CUDA card.

    python3 scripts/torch_flash_ab.py [--root DIR] [--label NAME]
                                      [--save FILE] [--against FILE]

Loads `repro_torch` from DIR/src (default: this checkout), builds its
flash-attention kernel there, and times it at every flash shape that
`chip_smoke.py` checks, with `chip_smoke.py`'s own timing helpers: the
kernel's device time per call (torch.profiler, the median of the
`flash_fwd_kernel` records), the CUDA-event time of one wrapper call,
and `scaled_dot_product_attention`'s device time on the same tensors
(`library_ms`, heads next to the batch and KV heads repeated, as
`chip_smoke.py` calls it). The shapes: the eleven `kernel_check` rows
(serving prefill f32 and bf16, the families' GQA shapes, ragged and
dh-256 ones), and the `fed_dryrun` ones (the neighbour web's call at
(B 8, S 32, 4 query heads over 1 KV head, dh 64) in f32 and bf16, that
call through the op's vmap rule nested over 256 clients x 8 neighbours,
the own forwards' vmap over 256 and 1,024 clients, and the f32 contract
point under a vmap over two copies).

Prints the card's name and power limit, then one JSON line per shape
with the checkout's launch plan where it has `flash_plan`. The inputs
come from one seeded generator, so every checkout sees the same
tensors. Each line says whether the output agrees with the checkout's
plain version (`plain_close`: max abs error under 2e-5 in f32, 2e-2 in
bf16) and, with `--against`, with the outputs another checkout saved
(`close` in the same sense, `bit_equal`). `--save` keeps every shape's
output in FILE (some 1.5 GB: put it under a gitignored directory).

To compare two versions of the kernel on one card, run it in turns on
both checkouts in one command (parent, change, change, parent), e.g.
with the parent unpacked by `git archive` into a gitignored directory.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# chip_smoke.py's kernel_check rows: (N, Sq, Sk, dh, causal, dtype, heads)
KERNEL_CHECK = (
    (96, 2048, 2048, 128, True, "float32", None),
    (96, 2048, 2048, 128, True, "bfloat16", None),
    (2, 512, 512, 128, True, "float32", None),
    (1, 1024, 512, 64, True, "float32", None),
    (2, 256, 512, 128, False, "float32", None),
    (3, 1000, 1000, 128, True, "float32", None),
    (2, 512, 512, 128, True, "bfloat16", None),
    (2, 512, 512, 256, True, "float32", None),
    (4, 2048, 2048, 128, True, "float32", (24, 8)),
    (4, 1500, 1500, 64, False, "float32", (12, 12)),     # whisper encoder
    (4, 2048, 2048, 128, True, "float32", (48, 8)))      # grok-1's GQA
# chip_smoke.py's fed_dryrun rows: the web's call, and through the vmap
# rule: (outer vmapped sizes, B, S, H, KV, dh, dtype)
FED_CALL = tuple((8, 32, 32, 64, True, dt, (4, 1))
                 for dt in ("float32", "bfloat16"))
FED_VMAP = (((256, 8), 8, 32, 4, 1, 64, "bfloat16"),
            ((256,), 8, 32, 4, 1, 64, "bfloat16"),
            ((1024,), 8, 32, 4, 1, 64, "bfloat16"))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def direct_case(torch, fa, ops, ref, gen, n, sq, sk, dh, causal, dt,
                heads):
    """(call, plain, library, plan args) of a kernel_check row, as
    `chip_smoke.check_flash` builds it."""
    dtype = getattr(torch, dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if heads is None:
        q, k, v = (torch.randn((n, s, dh), generator=gen, device="cuda")
                   .to(dtype) for s in (sq, sk, sk))
        return (lambda: fa.flash_attention(q, k, v, causal=causal),
                lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                lambda: sdpa(q[None], k[None], v[None],
                             is_causal=causal)[0],
                (n, sq, sk, 1, 1, dh, dtype, causal))
    h, kvh = heads
    q = torch.randn((n, sq, h, dh), generator=gen, device="cuda")
    k, v = (torch.randn((n, sk, kvh, dh), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    qh = q.movedim(2, 1)
    kh, vh = (t.movedim(2, 1).repeat_interleave(h // kvh, dim=1)
              for t in (k, v))
    return (lambda: ops.gqa_flash_attention(q, k, v, causal=causal),
            lambda: ops.gqa_flash_attention(q, k, v, causal=causal,
                                            use_kernel=False),
            lambda: sdpa(qh, kh, vh, is_causal=causal).movedim(1, 2),
            (n, sq, sk, h, kvh, dh, dtype, causal))


def vmap_case(torch, fa, gen, outer, b, s, h, kvh, dh, dt):
    """(call, plain, library, plan args) of the flash op under a nested
    vmap over `outer`, as `chip_smoke.check_flash_vmapped` builds it."""
    from torch.func import vmap
    dtype = getattr(torch, dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn((*outer, b, s, h, dh), generator=gen, device="cuda")
    k, v = (torch.randn((*outer, b, s, kvh, dh), generator=gen,
                        device="cuda") for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    nb = math.prod(outer) * b
    fq, fk, fv = (t.reshape(nb, *t.shape[len(outer) + 1:])
                  for t in (q, k, v))
    fn = lambda a, b_, c: fa.gqa_attention(a, b_, c, causal=True)  # noqa
    for _ in outer:
        fn = vmap(fn)

    def call():
        with torch.no_grad():
            return fn(q, k, v).reshape(nb, s, h, dh)

    qh = fq.movedim(2, 1)
    kh, vh = (t.movedim(2, 1).repeat_interleave(h // kvh, dim=1)
              for t in (fk, fv))
    return (call, lambda: fa.plain_gqa_attention(fq, fk, fv, True, 0.0),
            lambda: sdpa(qh, kh, vh, is_causal=True),
            (nb, s, s, h, kvh, dh, dtype, True))


def contract_case(torch, fa):
    """The f32 contract point under a vmap over two copies, as
    `chip_smoke.flash_vmap_contract_and_taint` builds it (no taint)."""
    from torch.func import vmap

    from repro_torch.analysis.registry import REGISTRY
    entry = REGISTRY["flash_attention"]
    point = entry.points[0]
    args, kwargs = entry.make_args(point)
    q, k, v = (torch.stack([t, t.flip(0)]).cuda() for t in args)

    def call():
        with torch.no_grad():
            return vmap(lambda a, b, c: fa.gqa_attention(a, b, c,
                                                         **kwargs))(q, k, v)

    def plain():
        return torch.stack([entry.twin_call((q[i], k[i], v[i]), kwargs)
                            for i in range(2)])

    return (call, plain, None,
            (2 * point["b"], point["s"], point["s"], point["h"],
             point["kv"], point["dh"], torch.float32, point["causal"]))


def agree(torch, got, other, tol, prefix=""):
    other = other.to(got.device)
    err = (got.float() - other.float()).abs().max().item()
    return {prefix + "max_abs_diff": err, prefix + "close": err < tol,
            prefix + "bit_equal": bool(torch.equal(got, other))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fa.KERNEL.function()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [("kernel_check", r, lambda r=r: direct_case(
        torch, fa, ops, ref, gen, *r)) for r in KERNEL_CHECK]
    cases += [("fed_dryrun", r, lambda r=r: direct_case(
        torch, fa, ops, ref, gen, *r)) for r in FED_CALL]
    cases += [("fed_dryrun_vmap", r, lambda r=r: vmap_case(
        torch, fa, gen, *r)) for r in FED_VMAP]
    cases.append(("fed_dryrun_contract", (), lambda: contract_case(torch,
                                                                   fa)))
    saved = {}
    other = torch.load(args.against) if args.against else {}
    for kind, row, make in cases:
        call, plain, lib, plan_args = make()
        dtype = plan_args[6]
        tol = TOL[str(dtype)[6:]]
        key = f"{kind}-{row}"
        out = {"label": args.label, "kind": kind, "shape": str(row)}
        if hasattr(fa, "flash_plan"):
            plan = fa.flash_plan(*plan_args, torch.cuda.get_device_properties(
                0).multi_processor_count)
            out["plan"] = {k: plan[k] for k in ("config", "items", "grid",
                                                "smem_bytes")}
        n0 = fa.KERNEL.launches
        got = call()
        out["launches"] = fa.KERNEL.launches - n0
        out.update(agree(torch, got, plain(), tol, "plain_"))
        if key in other:
            out.update(agree(torch, got, other[key], tol))
        if args.save:
            saved[key] = got.cpu()
        del got
        torch.cuda.empty_cache()
        out["kernel_ms"] = chip_smoke.device_ms(call, ("flash_fwd_kernel",))
        out["call_ms"] = chip_smoke.time_ms(call)
        out["library_ms"] = (chip_smoke.library_device_ms(lib)
                             if lib is not None else None)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())

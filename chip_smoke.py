#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   port's CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc per
   source, all started together).
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at larger ones from the JAX kernels'
   contract points, and times kernel, plain version and (for the LSH
   projection) one torch.matmul with the projection matrix materialised:
   device time per call from torch.profiler, and CUDA-event medians of
   whole calls after warm-up (`timings`). One JSON line per kernel and
   shape.
3. Drives the main path: `run_federation("mnist", rounds=2,
   backend="kernel")` on the card, with every kernel's launch count set
   to 0 just before and read just after (each must be > 0), then the same
   federation with `backend="oracle"`: round-0 neighbour ids and valid
   masks must be equal, accuracy per round within 0.02. A third,
   profiled run breaks round 1 down into its phases' host time, the
   device's busy time and the kernels that took it (`profile_round`).
4. Prints {"kernels": [...]} for every ported kernel, then, last,
   {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, without a CUDA device or
without the rest of the repository. Tolerances: LSH sums within
1e-5 * (|plain| + ||x_row||_2) and codes equal on every bit whose |sum|
> 1e-3; selection ids and weights equal; exchange l_ij and target within
rtol 1e-5 (atol 1e-5 for target entries near 0), valid and has_target
equal.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) FLOP/s,
# and int32 operations/s (64 INT32 lanes per SM, half the 128 f32 lanes).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT32_OP_PER_S = F32_FLOP_PER_S / 4
HASH_OPS = 8            # integer operations of one Rademacher hash


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, names=(), iters: int = 20):
    """Device time per call of fn() in ms: the summed durations of the
    CUDA activity it causes, from torch.profiler (kernels whose name
    contains one of `names`, or all activity when `names` is empty).
    None when the profiler records no such activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if is_device_work(e, DeviceType)
           and (not names or any(n in e.name for n in names))]
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / iters / 1e3


def is_device_work(e, DeviceType) -> bool:
    """A profiler event of device activity (kernel, copy, set), not the
    device-side image of a host `record_function` span."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("wpfed."))


def timings(kernel_fn, kernel_names, plain_fn, library_fn=None,
            plain_iters: int = 20):
    """kernel_ms: the kernel's own device time per call (CUDA events
    around the wrapper when the profiler sees no device activity);
    call_ms: CUDA events around one wrapper call, host overhead and
    input casts included; plain_ms / library_ms: all device time per
    call of the plain version / the library call, with their
    event-timed call_ms."""
    out = {"call_ms": time_ms(kernel_fn),
           "plain_call_ms": time_ms(plain_fn, iters=plain_iters)}
    out["kernel_ms"] = device_ms(kernel_fn, kernel_names) or out["call_ms"]
    out["plain_ms"] = (device_ms(plain_fn, iters=plain_iters)
                       or out["plain_call_ms"])
    out["library_ms"] = None
    if library_fn is not None:
        out["library_call_ms"] = time_ms(library_fn)
        out["library_ms"] = device_ms(library_fn) or out["library_call_ms"]
    return out


def bound(bytes_moved: float, ops_time_s: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    the operations' time at peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    if t_bytes >= ops_time_s:
        return t_bytes * 1e3, "bytes"
    return ops_time_s * 1e3, "operations"


def check_lsh(torch, m, p, bits, gen):
    from repro_torch.kernels import lsh_projection, ops, ref
    x = torch.randn((m, p), generator=gen, device="cuda") * 0.05
    k = lsh_projection.lsh_project_sums_batched(x, 7, bits=bits)
    pl = ref.lsh_project_sums_batched_ref(x, 7, bits=bits)
    torch.cuda.synchronize()
    scale = x.norm(dim=1, keepdim=True)
    err = (k - pl).abs()
    if not bool((err <= 1e-5 * (pl.abs() + scale)).all()):
        raise AssertionError(f"lsh sums disagree: max err {err.max().item()}")
    off_zero = pl.abs() > 1e-3
    if not torch.equal((k > 0)[off_zero], (pl > 0)[off_zero]):
        raise AssertionError("lsh code bits disagree off zero")
    n0 = lsh_projection.KERNEL.launches
    r = ops.rademacher_block(0, p, bits, 7, device="cuda")
    t = timings(lambda: lsh_projection.lsh_project_sums_batched(
                    x, 7, bits=bits),
                ("lsh_partial_kernel", "lsh_reduce_kernel"),
                lambda: ref.lsh_project_sums_batched_ref(x, 7, bits=bits),
                library_fn=lambda: torch.matmul(x, r), plain_iters=5)
    del r
    # f32 FMAs and the integer hash run on separate pipes: the larger wins
    ops_s = max(2.0 * m * p * bits / F32_FLOP_PER_S,
                HASH_OPS * p * bits / INT32_OP_PER_S)
    bms, by = bound(4.0 * m * p + 4.0 * m * bits, ops_s)
    return dict(**t, max_abs_err=err.max().item(), bound_ms=bms,
                bound_by=by, launches=lsh_projection.KERNEL.launches - n0)


def check_selection(torch, m, bits, n, gen, ties=False):
    from repro_torch.kernels import ref, selection
    w = bits // 32
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, w), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    grid = torch.tensor([0.0, 0.25, 0.5, 1.0], device="cuda")
    scores = (torch.zeros(m, device="cuda") if ties else
              grid[torch.randint(0, 4, (m,), generator=gen, device="cuda")])
    ki, kw = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                    num_neighbors=n)
    lut = ref.selection_lut(w, bits, 1.0, device=codes.device)
    pi, pw = ref.fused_select_ref(codes, scores, lut, num_neighbors=n)
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"selection disagrees at m={m}, bits={bits}")
    n0 = selection.KERNEL.launches
    t = timings(lambda: selection.fused_select(
                    codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
                ("fused_select_kernel",),
                lambda: ref.fused_select_ref(codes, scores, lut,
                                             num_neighbors=n))
    nsel = min(n, m - 1)
    bytes_moved = 4.0 * (m * w + m + w * 32 + 1) + 8.0 * m * nsel
    bms, by = bound(bytes_moved, 3.0 * m * m * w / INT32_OP_PER_S)
    diff = (kw - pw).abs()
    finite = diff[torch.isfinite(diff)]
    return dict(**t, max_abs_err=finite.max().item() if finite.numel()
                else 0.0, bound_ms=bms, bound_by=by,
                launches=selection.KERNEL.launches - n0)


def check_exchange(torch, m, n, r, c, gen, all_selected=False):
    from repro_torch.kernels import exchange, ref
    own = torch.randn((m, r, c), generator=gen, device="cuda") * 3
    nb = torch.randn((m, n, r, c), generator=gen, device="cuda") * 3
    y = torch.randint(0, c, (m, r), generator=gen, device="cuda")
    sel = (torch.ones((m, n), dtype=torch.bool, device="cuda")
           if all_selected else
           torch.rand((m, n), generator=gen, device="cuda") < 0.7)
    kl, kv, kt, kh = exchange.fused_exchange(own, nb, y, sel)
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(own, nb, y, sel)
    torch.cuda.synchronize()
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    if not (torch.equal(kv, pv) and torch.equal(kh, ph)):
        raise AssertionError(f"exchange masks disagree at {(m, n, r, c)}")
    n0 = exchange.KERNEL.launches
    t = timings(lambda: exchange.fused_exchange(own, nb, y, sel),
                ("fused_exchange_kernel",),
                lambda: ref.all_in_one_exchange_ref(own, nb, y, sel))
    bytes_moved = (4.0 * (2 * m * r * c + m * n * r * c + m * r + m * n)
                   + m * n * 2 + m)
    # per neighbour element: max, exp, sum, KL term (exp, sub, mul, add),
    # target add: ~10 f32 operations
    bms, by = bound(bytes_moved, 10.0 * m * n * r * c / F32_FLOP_PER_S)
    err = max((kl - pl).abs().max().item(), (kt - pt).abs().max().item())
    return dict(**t, max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=exchange.KERNEL.launches - n0)


def profile_round(run_federation, names, round_idx: int = 1):
    """Profile a kernel-backed mnist federation and break round
    `round_idx` down: its wall time (the "wpfed.round.<i>" span), the
    host time of each phase span, the device's busy time (summed CUDA
    activity starting inside the span) and idle share, that busy time by
    the phase that launched it (by start time), the device launches, the
    ported kernels' device time and the five costliest device kernels."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_federation("mnist", rounds=round_idx + 1, backend="kernel",
                       device="cuda", log=None)
    evts = prof.events()
    span = next(e for e in evts if e.name == f"wpfed.round.{round_idx}")
    lo, hi = span.time_range.start, span.time_range.end
    inside = [e for e in evts if lo <= e.time_range.start < hi]
    spans = [e for e in inside if e.device_type == DeviceType.CPU
             and e.name.startswith("wpfed.") and e is not span]
    phases, dev_phase, by_name = Counter(), Counter(), Counter()
    for e in spans:
        phases[e.name[len("wpfed."):]] += e.time_range.elapsed_us() / 1e3
    device = [e for e in inside if is_device_work(e, DeviceType)]
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name[:80]] += ms
        owner = next((p.name[len("wpfed."):] for p in spans
                      if p.time_range.start <= e.time_range.start
                      < p.time_range.end), "other")
        dev_phase[owner] += ms
    wall = span.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return {"round": round_idx, "wall_ms": wall, "phases_ms": dict(phases),
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_phase": dict(dev_phase),
            "device_launches": len(device),
            "ported_kernels_ms": sum(v for k, v in by_name.items()
                                     if any(n in k for n in names)),
            "top_device_ms": by_name.most_common(5)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # 1. hardware and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, exchange, lsh_projection, selection
    from repro_torch.launch.fed import run_federation

    resolve_device("cuda")               # strict f32: TF32 off
    kernels = {"lsh_projection": lsh_projection.KERNEL,
               "selection": selection.KERNEL, "exchange": exchange.KERNEL}
    t0 = time.perf_counter()
    logs = build.build_all(kernels.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in logs.items()}})

    # 2. each kernel against its plain version on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main_shape = {}
    checks = [
        ("lsh_projection", dict(m=10, p=421_888, bits=256), True,
         lambda: check_lsh(torch, 10, 421_888, 256, gen)),
        ("lsh_projection", dict(m=16, p=4096, bits=256), False,
         lambda: check_lsh(torch, 16, 4096, 256, gen)),
        ("lsh_projection", dict(m=256, p=421_888, bits=256), False,
         lambda: check_lsh(torch, 256, 421_888, 256, gen)),
        ("selection", dict(m=10, bits=256, n=9), True,
         lambda: check_selection(torch, 10, 256, 9, gen)),
        ("selection", dict(m=10, bits=256, n=9, ties=True), False,
         lambda: check_selection(torch, 10, 256, 9, gen, ties=True)),
        ("selection", dict(m=1024, bits=256, n=16), False,
         lambda: check_selection(torch, 1024, 256, 16, gen)),
        ("selection", dict(m=768, bits=512, n=16), False,
         lambda: check_selection(torch, 768, 512, 16, gen)),
        ("exchange", dict(m=10, n=9, r=64, c=10), True,
         lambda: check_exchange(torch, 10, 9, 64, 10, gen,
                                all_selected=True)),
        ("exchange", dict(m=8, n=16, r=64, c=1024), False,
         lambda: check_exchange(torch, 8, 16, 64, 1024, gen)),
    ]
    for name, shape, is_main, run in checks:
        res = run()
        emit({"phase": "kernel_check", "kernel": name, "shape": shape,
              "main_path_shape": is_main, **res})
        if is_main:
            main_shape[name] = res

    # 3. the main path, through the kernels, then through the plain versions
    for k in kernels.values():
        k.launches = 0
    _, hist = run_federation("mnist", rounds=2, backend="kernel",
                             device="cuda", log=None)
    launches = {name: k.launches for name, k in kernels.items()}
    for h in hist:
        emit({"phase": "main_path", "backend": "kernel", "round": h["round"],
              "acc": h["acc"], "mean_loss": h["mean_loss"],
              "seconds": h["seconds"]})
    emit({"phase": "main_path_launches", **launches})
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    _, hist_o = run_federation("mnist", rounds=2, backend="oracle",
                               device="cuda", log=None)
    for h in hist_o:
        emit({"phase": "main_path", "backend": "oracle", "round": h["round"],
              "acc": h["acc"], "mean_loss": h["mean_loss"],
              "seconds": h["seconds"]})
    if hist[0]["neighbor_ids"] != hist_o[0]["neighbor_ids"] or \
            hist[0]["valid_mask"] != hist_o[0]["valid_mask"]:
        raise AssertionError("round-0 selection differs between backends")
    for a, b in zip(hist, hist_o):
        if not (abs(a["acc"] - b["acc"]) <= 0.02
                and all(v == v and abs(v) < 1e30 for v in
                        (a["mean_loss"], b["mean_loss"]))):
            raise AssertionError(f"round {a['round']}: kernel and oracle "
                                 "runs disagree or are not finite")

    emit({"phase": "profile", **profile_round(
        run_federation, ("lsh_partial_kernel", "lsh_reduce_kernel",
                         "fused_select_kernel", "fused_exchange_kernel"))})

    # 4. every ported kernel
    meta = {
        "lsh_projection": ("src/repro_torch/kernels/csrc/lsh_projection.cu",
                           "src/repro/kernels/lsh_projection.py:134"),
        "selection": ("src/repro_torch/kernels/csrc/selection.cu",
                      "src/repro/kernels/selection.py:180"),
        "exchange": ("src/repro_torch/kernels/csrc/exchange.cu",
                     "src/repro/kernels/exchange.py:153"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name],
         "max_abs_err": main_shape[name]["max_abs_err"],
         "ms": main_shape[name]["kernel_ms"],
         "plain_ms": main_shape[name]["plain_ms"],
         "bound_ms": main_shape[name]["bound_ms"],
         "bound_by": main_shape[name]["bound_by"],
         "library_ms": main_shape[name]["library_ms"]}
        for name in kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

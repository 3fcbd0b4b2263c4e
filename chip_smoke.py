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
   whole calls after warm-up (`timings`). The column-tiled selection is
   also held against the one-shot kernel wherever that runs (to
   M = 46,489) and checked at M = 65,536 past it; the streamed exchange
   is held against both plain versions, up to a 100,352-class
   vocabulary, and the one-shot kernel is timed at each of its shapes.
   One JSON line per kernel and shape.
3. Drives the main path: `run_federation("mnist", rounds=2,
   backend="kernel")` on the card, then the same federation with
   `tiling="tiled"`; every kernel's launch count is set to 0 just before
   each and read just after. The one-shot run must launch the LSH,
   one-shot selection and one-shot exchange kernels and not the tiled
   pair, the tiled run the reverse. A run with `backend="oracle"` and
   the tiled run must give the one-shot run's round-0 neighbour ids and
   valid masks, and accuracy per round within 0.02. One
   `select_partners` call at M = 65,536 with `tiling="auto"` must launch
   the tiled selection. Two profiled runs (one-shot and tiled) break
   round 1 down into its phases' host time, the device's busy time and
   the kernels that took it (`profile_round`).
4. Prints {"kernels": [...]} for every ported kernel, then, last,
   {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, without a CUDA device or
without the rest of the repository. Tolerances: LSH sums within
1e-5 * (|plain| + ||x_row||_2) and codes equal on every bit whose |sum|
> 1e-3; selection ids and weights equal (one-shot and tiled); one-shot
exchange l_ij and target within rtol 1e-5 (atol 1e-5 for target entries
near 0); streamed exchange l_ij and target within rtol 2e-5, atol 1e-5
of both plain versions; valid and has_target equal.
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
STREAMED_EXCHANGE_NAMES = ("exchange_stats_kernel", "exchange_mask_kernel",
                           "exchange_target_kernel")


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
    """Device time per call of fn() in ms, from torch.profiler. With
    `names` (a wrapper's kernels, each launched once per call): the sum
    over names of the median duration of the kernels whose name contains
    it, which a dropped activity record does not bias (in one H100 run
    the summed records of 20 calls of a 15 ms kernel came to a third of
    the CUDA-event time). Without: all device activity of
    the `iters` calls, summed, per call. None when the profiler records
    no such activity."""
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
    dev = [e for e in prof.events() if is_device_work(e, DeviceType)]
    if names:
        per_name = [[e.time_range.elapsed_us() for e in dev if n in e.name]
                    for n in names]
        if not all(per_name):
            return None
        return sum(statistics.median(d) for d in per_name) / 1e3
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
           "plain_call_ms": time_ms(plain_fn, warmup=min(3, plain_iters),
                                    iters=plain_iters)}
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


def selection_inputs(torch, m, bits, gen, ties):
    """Random packed codes (M, W) int32 and Eq. 7-like scores on a
    4-value grid (ties across columns), or all-zero scores (round 0)."""
    w = bits // 32
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, w), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    grid = torch.tensor([0.0, 0.25, 0.5, 1.0], device="cuda")
    scores = (torch.zeros(m, device="cuda") if ties else
              grid[torch.randint(0, 4, (m,), generator=gen, device="cuda")])
    return codes, scores


def selection_bound(m, w, n):
    """Codes, scores, table and the (M, N) outputs once; 3*M*M*W integer
    operations (XOR, popcount, add) at the int32 rate."""
    nsel = min(n, m - 1)
    bytes_moved = 4.0 * (m * w + m + w * 32 + 1) + 8.0 * m * nsel
    return bound(bytes_moved, 3.0 * m * m * w / INT32_OP_PER_S)


def max_finite_diff(a, b) -> float:
    diff = (a - b).abs()
    finite = diff[diff.isfinite()]
    return finite.max().item() if finite.numel() else 0.0


def check_selection(torch, m, bits, n, gen, ties=False):
    from repro_torch.kernels import ref, selection
    codes, scores = selection_inputs(torch, m, bits, gen, ties)
    ki, kw = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                    num_neighbors=n)
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
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
    bms, by = selection_bound(m, bits // 32, n)
    return dict(**t, max_abs_err=max_finite_diff(kw, pw), bound_ms=bms,
                bound_by=by, launches=selection.KERNEL.launches - n0)


def check_selection_tiled(torch, m, bits, n, gen, ties=False):
    """The column-tiled kernel against `fused_select_tiled_ref` (4096 x
    4096 tiles past M = 8192, so the plain version's temporaries stay at
    a few GB) and, up to M = 46,489, against the one-shot kernel, whose
    device time is recorded beside it (`oneshot_ms`)."""
    from repro_torch.kernels import ref, selection
    from repro_torch.kernels.build import MAX_SHARED_BYTES
    codes, scores = selection_inputs(torch, m, bits, gen, ties)
    blocks = (dict(block_m=4096, block_k=4096) if m > 8192 else {})
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
    ki, kw = selection.fused_select_tiled(codes, scores, bits=bits,
                                          gamma=1.0, num_neighbors=n)
    pi, pw = ref.fused_select_tiled_ref(codes, scores, lut, num_neighbors=n,
                                        **blocks)
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"tiled selection disagrees with its plain "
                             f"version at m={m}, bits={bits}")
    out = {"oneshot_ms": None}
    if selection.oneshot_smem_bytes(m) <= MAX_SHARED_BYTES:
        oi, ow = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                        num_neighbors=n)
        torch.cuda.synchronize()
        if not (torch.equal(ki, oi) and torch.equal(kw, ow)):
            raise AssertionError(f"tiled selection disagrees with the "
                                 f"one-shot kernel at m={m}, bits={bits}")
        out["oneshot_ms"] = device_ms(lambda: selection.fused_select(
            codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
            ("fused_select_kernel",))
    n0 = selection.TILED_KERNEL.launches
    t = timings(lambda: selection.fused_select_tiled(
                    codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
                ("select_tiled_kernel",),
                lambda: ref.fused_select_tiled_ref(
                    codes, scores, lut, num_neighbors=n, **blocks),
                plain_iters=1 if m > 8192 else (3 if m >= 1024 else 20))
    bms, by = selection_bound(m, bits // 32, n)
    return dict(**t, **out, max_abs_err=max_finite_diff(kw, pw),
                bound_ms=bms, bound_by=by,
                launches=selection.TILED_KERNEL.launches - n0)


def exchange_inputs(torch, m, n, r, c, gen, all_selected):
    own = torch.randn((m, r, c), generator=gen, device="cuda") * 3
    nb = torch.randn((m, n, r, c), generator=gen, device="cuda") * 3
    y = torch.randint(0, c, (m, r), generator=gen, device="cuda")
    sel = (torch.ones((m, n), dtype=torch.bool, device="cuda")
           if all_selected else
           torch.rand((m, n), generator=gen, device="cuda") < 0.7)
    return own, nb, y, sel


def exchange_bound(m, n, r, c):
    """Own and neighbour logits, labels and selection read once, l_ij,
    valid, target and has_target written once; per neighbour element
    max, exp, sum, the KL term (exp, sub, mul, add) and the target add:
    ~10 f32 operations."""
    bytes_moved = (4.0 * (2 * m * r * c + m * n * r * c + m * r + m * n)
                   + m * n * 2 + m)
    return bound(bytes_moved, 10.0 * m * n * r * c / F32_FLOP_PER_S)


def check_exchange(torch, m, n, r, c, gen, all_selected=False):
    from repro_torch.kernels import exchange, ref
    own, nb, y, sel = exchange_inputs(torch, m, n, r, c, gen, all_selected)
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
    bms, by = exchange_bound(m, n, r, c)
    err = max((kl - pl).abs().max().item(), (kt - pt).abs().max().item())
    return dict(**t, max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=exchange.KERNEL.launches - n0)


def check_exchange_streamed(torch, m, n, r, c, gen, all_selected=False):
    """The streamed kernel against `streamed_exchange_ref` and
    `all_in_one_exchange_ref`; the one-shot kernel's device time at the
    same inputs is recorded beside it (`oneshot_ms`)."""
    from repro_torch.kernels import exchange, ref
    own, nb, y, sel = exchange_inputs(torch, m, n, r, c, gen, all_selected)
    kl, kv, kt, kh = exchange.fused_exchange_streamed(own, nb, y, sel)
    err = 0.0
    for plain in (ref.streamed_exchange_ref, ref.all_in_one_exchange_ref):
        pl, pv, pt, ph = plain(own, nb, y, sel)
        torch.cuda.synchronize()
        torch.testing.assert_close(kl, pl, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(kt, pt, rtol=2e-5, atol=1e-5)
        if not (torch.equal(kv, pv) and torch.equal(kh, ph)):
            raise AssertionError(f"streamed exchange masks disagree with "
                                 f"{plain.__name__} at {(m, n, r, c)}")
        err = max(err, (kl - pl).abs().max().item(),
                  (kt - pt).abs().max().item())
        del pl, pv, pt, ph
    oneshot_ms = device_ms(lambda: exchange.fused_exchange(own, nb, y, sel),
                           ("fused_exchange_kernel",))
    n0 = exchange.STREAMED_KERNEL.launches
    t = timings(lambda: exchange.fused_exchange_streamed(own, nb, y, sel),
                STREAMED_EXCHANGE_NAMES,
                lambda: ref.streamed_exchange_ref(own, nb, y, sel),
                plain_iters=2 if c > 8192 else 20)
    bms, by = exchange_bound(m, n, r, c)
    return dict(**t, oneshot_ms=oneshot_ms, max_abs_err=err, bound_ms=bms,
                bound_by=by, launches=exchange.STREAMED_KERNEL.launches - n0)


def profile_round(run_federation, names, tiling: str = "auto",
                  round_idx: int = 1):
    """Profile a kernel-backed mnist federation under `tiling` and break round
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
                       tiling=tiling, device="cuda", log=None)
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
    return {"tiling": tiling, "round": round_idx, "wall_ms": wall, "phases_ms": dict(phases),
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_phase": dict(dev_phase),
            "device_launches": len(device),
            "ported_kernels_ms": sum(v for k, v in by_name.items()
                                     if any(n in k for n in names)),
            "top_device_ms": by_name.most_common(5)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_main_path(run_federation, kernels, **kw):
    """Two mnist rounds on the card, with every kernel's launch count set
    to 0 just before and read just after; emits one line per round."""
    for k in kernels.values():
        k.launches = 0
    _, hist = run_federation("mnist", rounds=2, device="cuda", log=None,
                             **kw)
    launches = {name: k.launches for name, k in kernels.items()}
    for h in hist:
        emit({"phase": "main_path", **kw, "round": h["round"],
              "acc": h["acc"], "mean_loss": h["mean_loss"],
              "seconds": h["seconds"]})
    return hist, launches


def expect_launches(launches, used, unused, label):
    """Every kernel of `used` launched at least once, none of `unused`."""
    emit({"phase": "main_path_launches", "run": label, **launches})
    missing = [name for name in used if launches[name] == 0]
    stray = [name for name in unused if launches[name] != 0]
    if missing or stray:
        raise AssertionError(f"{label} run launched no {missing} kernel "
                             f"and {stray} kernels it must not")


def expect_same_run(hist, base, label):
    """Round-0 selection and masks equal, accuracy within 0.02 per round,
    finite losses."""
    if hist[0]["neighbor_ids"] != base[0]["neighbor_ids"] or \
            hist[0]["valid_mask"] != base[0]["valid_mask"]:
        raise AssertionError(f"round-0 selection of the {label} run differs "
                             "from the one-shot kernel run")
    for a, b in zip(hist, base):
        if not (abs(a["acc"] - b["acc"]) <= 0.02
                and all(v == v and abs(v) < 1e30 for v in
                        (a["mean_loss"], b["mean_loss"]))):
            raise AssertionError(f"round {a['round']}: {label} and one-shot "
                                 "kernel runs disagree or are not finite")


def check_auto_tiling_at_scale(torch, gen, m=65_536, bits=256, n=16):
    """One `select_partners` call past the one-shot limit with
    tiling="auto" must launch the tiled kernel, not the one-shot one, and
    give the tiled wrapper's ids."""
    from repro_torch.configs.paper_models import FedConfig
    from repro_torch.core.neighbor import select_partners
    from repro_torch.kernels import selection
    codes, scores = selection_inputs(torch, m, bits, gen, ties=False)
    fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits)
    t0, o0 = selection.TILED_KERNEL.launches, selection.KERNEL.launches
    ids, mask = select_partners(codes, scores, fed, backend="kernel",
                                tiling="auto")
    launched = (selection.TILED_KERNEL.launches - t0,
                selection.KERNEL.launches - o0)
    want, _ = selection.fused_select_tiled(codes, scores, bits=bits,
                                           gamma=fed.gamma, num_neighbors=n)
    torch.cuda.synchronize()
    emit({"phase": "auto_tiling", "m": m, "bits": bits, "n": n,
          "tiled_launches": launched[0], "oneshot_launches": launched[1]})
    if launched != (1, 0) or not torch.equal(ids, want) or \
            not bool(mask.all()):
        raise AssertionError(f"select_partners(tiling='auto') at M={m} did "
                             f"not take the tiled kernel: {launched}")


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
               "selection": selection.KERNEL, "exchange": exchange.KERNEL,
               "selection_tiled": selection.TILED_KERNEL,
               "exchange_streamed": exchange.STREAMED_KERNEL}
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
        ("selection_tiled", dict(m=10, bits=256, n=9), True,
         lambda: check_selection_tiled(torch, 10, 256, 9, gen)),
        ("selection_tiled", dict(m=10, bits=256, n=9, ties=True), False,
         lambda: check_selection_tiled(torch, 10, 256, 9, gen, ties=True)),
    ] + [
        ("selection_tiled", dict(m=m, bits=bits, n=16), False,
         lambda m=m, bits=bits: check_selection_tiled(torch, m, bits, 16,
                                                      gen))
        for m, bits in ((1024, 256), (2048, 256), (4096, 512), (65_536, 256))
    ] + [
        ("exchange_streamed", dict(m=10, n=9, r=64, c=10), True,
         lambda: check_exchange_streamed(torch, 10, 9, 64, 10, gen,
                                         all_selected=True)),
    ] + [
        ("exchange_streamed", dict(m=m, n=n, r=r, c=c), False,
         lambda m=m, n=n, r=r, c=c: check_exchange_streamed(torch, m, n, r, c,
                                                            gen))
        for m, n, r, c in ((8, 8, 32, 2048), (4, 16, 64, 1024),
                           (4, 8, 16, 4096), (8, 8, 32, 100_352))
    ]
    for name, shape, is_main, run in checks:
        res = run()
        emit({"phase": "kernel_check", "kernel": name, "shape": shape,
              "main_path_shape": is_main, **res})
        if is_main:
            main_shape[name] = res
        torch.cuda.empty_cache()

    # 3. the main path: one-shot kernels, plain versions, tiled kernels
    oneshot = ("lsh_projection", "selection", "exchange")
    tiled = ("lsh_projection", "selection_tiled", "exchange_streamed")
    hist, launches = run_main_path(run_federation, kernels, backend="kernel")
    expect_launches(launches, oneshot, set(kernels) - set(oneshot),
                    "one-shot")
    hist_o, _ = run_main_path(run_federation, kernels, backend="oracle")
    expect_same_run(hist_o, hist, "oracle")
    hist_t, launches_t = run_main_path(run_federation, kernels,
                                       backend="kernel", tiling="tiled")
    expect_launches(launches_t, tiled, set(kernels) - set(tiled), "tiled")
    expect_same_run(hist_t, hist, "tiled")
    for name in ("selection_tiled", "exchange_streamed"):
        launches[name] = launches_t[name]
    check_auto_tiling_at_scale(torch, gen)

    names = ("lsh_partial_kernel", "lsh_reduce_kernel", "fused_select_kernel",
             "fused_exchange_kernel", "select_tiled_kernel",
             *STREAMED_EXCHANGE_NAMES)
    for tiling in ("oneshot", "tiled"):
        emit({"phase": "profile", **profile_round(run_federation, names,
                                                  tiling=tiling)})

    # 4. every ported kernel
    meta = {
        "lsh_projection": ("src/repro_torch/kernels/csrc/lsh_projection.cu",
                           "src/repro/kernels/lsh_projection.py:134"),
        "selection": ("src/repro_torch/kernels/csrc/selection.cu",
                      "src/repro/kernels/selection.py:180"),
        "exchange": ("src/repro_torch/kernels/csrc/exchange.cu",
                     "src/repro/kernels/exchange.py:153"),
        "selection_tiled": ("src/repro_torch/kernels/csrc/selection_tiled.cu",
                            "src/repro/kernels/selection.py:271"),
        "exchange_streamed": (
            "src/repro_torch/kernels/csrc/exchange_streamed.cu",
            "src/repro/kernels/exchange.py:309"),
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

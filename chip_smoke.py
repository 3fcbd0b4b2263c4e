#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   port's CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc per
   source, all started together; the batched and single-client LSH
   kernels share a source).
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at larger ones from the JAX kernels'
   contract points, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (torch.matmul
   with the projection matrix materialised for the LSH kernels,
   torch.cdist(p=0) on unpacked bits for the Hamming kernel): device
   time per call from torch.profiler, and CUDA-event medians of whole
   calls after warm-up (`timings`). The column-tiled selection is also
   held against the one-shot kernel wherever that runs (to M = 46,489)
   and checked at M = 65,536 past it; the one-shot exchange at the main
   shape, at C = 1,024 and at the ANN federations' M = 4,096 and 65,536
   (N = 16, R = 64, C = 10; the plain version's peak allocation
   printed), the streamed exchange against both plain versions up to a
   100,352-class vocabulary, each exchange launched twice and required
   bit-identical, with the wrapper's launch plan (`oneshot_plan`,
   `streamed_plan`) printed and its kernels timed as the plan launches
   them; the
   ANN selection runs on `ann_candidates` at the defaults (prefix 10,
   probes 8): the main shape, all ties, clustered codes at M = 4096 and
   65,536, and with prefix_bits=0 against the one-shot kernel; the
   flash-attention kernel at the serving path's shape (N = 4 * 24 heads,
   Sq = Sk = 2048, dh = 128, f32, causal) and the same in bf16, at the
   JAX kernel's contract points, bidirectional with Sq != Sk, at lengths
   that are no tile multiple, in bf16, at dh = 256 and on the model's GQA
   layout, timed beside torch's scaled_dot_product_attention
   (`library_ms`, never called by the port) and bounded on its route
   (the tensor cores: f32 by 3xTF32 at 495 / 3 TFLOP/s, bf16 at 989;
   `cuda_core_bound_ms` at the f32 CUDA-core 67). The Hamming checks
   print the path the launch took (small or tiled). The LSH checks print
   the split length L (`lsh_projection.split_len`, from P alone), the
   instance the launch took (single / few / many rows, with rows and bits
   per block) and `order_equal`: the kernel's sums equal to the order
   twin `ref.lsh_project_sums_split_order` bit for bit (and the
   single-client sums to the batched row); either raises when false.
   The batched LSH checks also print the row groups the wrapper launched
   and the call's peak allocation, and raise when it passes the plan's
   scratch and output (M=65,536, P=12,288 runs in groups).
   One JSON line per kernel and shape.
3. Drives the main paths, every kernel's launch count set to 0 just
   before each and read just after: `run_federation("mnist", rounds=2,
   backend="kernel")` on the card, the same with `tiling="tiled"`, and
   with `backend="ann"`. The one-shot run must launch the LSH, one-shot
   selection and one-shot exchange kernels and no other, the tiled run
   the LSH kernel and the tiled pair, the ANN run the LSH kernel, the
   ANN selection (exactly twice) and the one-shot exchange. A run with
   `backend="oracle"` and the tiled run must give the one-shot run's
   round-0 neighbour ids and valid masks, the ANN run its round-0 id
   sets, in the order of `ann_select_ref` on the round-0 codes; each
   within 0.02 accuracy per round. On the one-shot run's final state,
   each client's own code (`client_lsh_code`, the single-client kernel)
   must equal its published row, and the unfused Eq. 6-8 composition
   through the Hamming kernel must give the fused kernel's ids. At
   M = 65,536, `select_partners` must take the tiled kernel with
   `tiling="auto"` and the ANN kernel with `backend="auto"` (with K,
   occupancy, times and recall against the tiled exact kernel). Three
   profiled runs (one-shot, tiled, ANN) break round 1 down into its
   phases' host time, the device's busy time and the kernels that took
   it (`profile_round`).
4. Path 4, LM serving: `serve("minitron-4b", reduced=False, batch=4,
   prompt_len=2048, max_new=32)` on the card (Minitron-4B at its
   published widths, 32 layers, random weights from seed 0), launch
   counts set to 0 just before: the flash-attention kernel must launch
   exactly 32 times (once per layer of the prefill, never in decode) and
   no other kernel. The same call on the same weights with the "naive"
   attention (no launch) must give prefill logits within rtol 1e-4, atol
   1e-4, and the same tokens, except from a step where the naive run's
   two largest logits lie within 1e-3. Prints the prefill seconds, the
   decode tokens/s, the peak device memory, the kernel's device time in
   a profiled prefill and a profile of three decode steps (host ms,
   device busy ms, idle share, launches, costliest kernels).
5. Prints {"kernels": [...]} for every ported kernel, then, last,
   {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, without a CUDA device or
without the rest of the repository. Tolerances: LSH sums within
1e-5 * (|plain| + ||x_row||_2) and codes equal on every bit whose |sum|
> 1e-3 (a client's own code against its published row likewise);
selection ids and weights equal (one-shot, tiled and ANN); Hamming
distances equal; unfused selection ids equal to the fused kernel's
except where two Eq. 8 weights are within 1 ulp; one-shot exchange l_ij
and target within rtol 1e-5 (atol 1e-5 for target entries near 0);
streamed exchange l_ij and target within rtol 2e-5, atol 1e-5 of both
plain versions; valid and has_target equal; flash attention max abs
error 2e-5 in f32 and 2e-2 in bf16 on unit-normal inputs (the JAX
kernel's test bound).
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) FLOP/s,
# and int32 operations/s (64 INT32 lanes per SM, half the 128 f32 lanes);
# the tensor cores' dense TF32 and bf16 FLOP/s. An f32-accurate product
# on the tensor cores takes three TF32 products (3xTF32), so f32 work runs
# there at a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT32_OP_PER_S = F32_FLOP_PER_S / 4
TF32_FLOP_PER_S = 495e12
F32_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3
BF16_FLOP_PER_S = 989e12
# __popc per SM per clock on compute capability 9.0 (CUDA programming
# guide, arithmetic instruction throughput), at the H100 SXM's 1.98 GHz
POPC_PER_S = 16 * 132 * 1.98e9
HASH_OPS = 8            # integer operations of one Rademacher hash
STREAMED_EXCHANGE_NAMES = ("exchange_stats_kernel", "exchange_merge_kernel",
                           "exchange_mask_kernel", "exchange_target_kernel")


def streamed_exchange_names(exchange, m, n, r, c):
    """The streamed wrapper's kernels at an (M, N, R, C) call, as its
    `streamed_plan` says: the merge kernel where rows have many chunks
    (`merged`), the target kernel unless the mask launch writes the
    target (`fused`). A checkout without that plan launches stats, mask
    and target."""
    plan = getattr(exchange, "streamed_plan", None)
    if plan is None:
        return tuple(k for k in STREAMED_EXCHANGE_NAMES if "merge" not in k)
    p = plan(m, n, r, c)
    return tuple(k for k in STREAMED_EXCHANGE_NAMES
                 if ("merge" not in k or p["merged"])
                 and ("target" not in k or not p["fused"]))


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


def device_ms(fn, names=(), iters: int = 20, per_call: int = 1):
    """Device time per call of fn() in ms, from torch.profiler. With
    `names` (a wrapper's kernels, each launched `per_call` times per
    call): the sum over names of the median duration of the kernels
    whose name contains it, times `per_call`, which a dropped activity
    record does not bias (in one H100 run
    the summed records of 20 calls of a 15 ms kernel came to a third of
    the CUDA-event time). Without: all device activity of the `iters`
    calls, summed, per call. None when the profiler records no such
    activity."""
    fn()
    dev = profiled_device_events(fn, iters)
    if names:
        per_name = [[e.time_range.elapsed_us() for e in dev if n in e.name]
                    for n in names]
        if not all(per_name):
            return None
        return per_call * sum(statistics.median(d) for d in per_name) / 1e3
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / iters / 1e3


def library_device_ms(fn, iters: int = 20):
    """Device time per call of one library call in ms: for each kernel
    name it launches, the median duration times the launches per call
    (rounded, at least 1). A library call launches a few fixed kernels,
    so medians keep dropped activity records from biasing the time (in
    one H100 run the profiler kept half of SDPA's records). None when
    the profiler records no device activity."""
    from collections import defaultdict
    fn()
    per_name = defaultdict(list)
    for e in profiled_device_events(fn, iters):
        per_name[e.name].append(e.time_range.elapsed_us())
    if not per_name:
        return None
    return sum(statistics.median(d) * max(1, round(len(d) / iters))
               for d in per_name.values()) / 1e3


def profiled_device_events(fn, iters: int):
    """The device activity of `iters` calls of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if is_device_work(e, DeviceType)]


def is_device_work(e, DeviceType) -> bool:
    """A profiler event of device activity (kernel, copy, set), not the
    device-side image of a host `record_function` span."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("wpfed."))


def timings(kernel_fn, kernel_names, plain_fn, library_fn=None,
            plain_iters: int = 20, per_call: int = 1):
    """kernel_ms: the kernel's own device time per call (CUDA events
    around the wrapper when the profiler sees no device activity);
    call_ms: CUDA events around one wrapper call, host overhead and
    input casts included; plain_ms: all device time per call of the
    plain version; library_ms: the library call's device time by kernel
    name (`library_device_ms`); each with its event-timed call_ms.
    `per_call`: launches of each kernel name per wrapper call."""
    out = {"call_ms": time_ms(kernel_fn),
           "plain_call_ms": time_ms(plain_fn, warmup=min(3, plain_iters),
                                    iters=plain_iters)}
    out["kernel_ms"] = (device_ms(kernel_fn, kernel_names, per_call=per_call)
                        or out["call_ms"])
    out["plain_ms"] = (device_ms(plain_fn, iters=plain_iters)
                       or out["plain_call_ms"])
    out["library_ms"] = None
    if library_fn is not None:
        out["library_call_ms"] = time_ms(library_fn)
        out["library_ms"] = (library_device_ms(library_fn)
                             or out["library_call_ms"])
    return out


def bound(bytes_moved: float, ops_time_s: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    the operations' time at peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    if t_bytes >= ops_time_s:
        return t_bytes * 1e3, "bytes"
    return ops_time_s * 1e3, "operations"


LSH_NAMES = ("lsh_partial", "lsh_reduce")


def lsh_order(torch, x, k, bits):
    """split_len, the instance the launch took (single / few / many rows,
    with its rows and bits per block), the groups of rows the batched
    wrapper launches one by one, and whether the kernel's sums equal
    the order twin's bit for bit; raises when they do not."""
    from repro_torch.kernels import lsh_projection, ref
    m, p = x.shape
    chunk = lsh_projection.split_len(p)
    twin = ref.lsh_project_sums_split_order(x, 7, bits=bits, chunk=chunk)
    equal = bool(torch.equal(k.reshape(m, bits), twin))
    del twin
    if not equal:
        raise AssertionError(f"lsh kernel differs from the order twin at "
                             f"M={m}, P={p}, L={chunk}")
    choice = lsh_projection.launch_choice(m, p, bits)
    return {"split_len": chunk, **choice,
            "row_groups": len(lsh_projection.row_groups(m, p, bits)),
            "order_equal": equal}


def check_lsh(torch, m, p, bits, gen):
    from repro_torch.kernels import lsh_projection, ops, ref
    x = torch.randn((m, p), generator=gen, device="cuda") * 0.05
    # the call's own allocations: its output and the scratch of the plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k = lsh_projection.lsh_project_sums_batched(x, 7, bits=bits)
    call_peak_bytes = torch.cuda.max_memory_allocated() - base
    _, groups, shape = lsh_projection.split_plan(p, m, bits)
    planned = 4 * (math.prod(shape) + m * bits)
    if call_peak_bytes > planned + (1 << 20):
        raise AssertionError(f"lsh call allocated {call_peak_bytes} bytes, "
                             f"planned {planned}")
    pl = ref.lsh_project_sums_batched_ref(x, 7, bits=bits)
    torch.cuda.synchronize()
    scale = x.norm(dim=1, keepdim=True)
    err = (k - pl).abs()
    if not bool((err <= 1e-5 * (pl.abs() + scale)).all()):
        raise AssertionError(f"lsh sums disagree: max err {err.max().item()}")
    off_zero = pl.abs() > 1e-3
    if not torch.equal((k > 0)[off_zero], (pl > 0)[off_zero]):
        raise AssertionError("lsh code bits disagree off zero")
    order = lsh_order(torch, x, k, bits)
    n0 = lsh_projection.KERNEL.launches
    r = ops.rademacher_block(0, p, bits, 7, device="cuda")
    t = timings(lambda: lsh_projection.lsh_project_sums_batched(
                    x, 7, bits=bits),
                LSH_NAMES,
                lambda: ref.lsh_project_sums_batched_ref(x, 7, bits=bits),
                library_fn=lambda: torch.matmul(x, r), plain_iters=5,
                per_call=len(groups))
    del r
    # f32 FMAs and the integer hash run on separate pipes: the larger wins
    ops_s = max(2.0 * m * p * bits / F32_FLOP_PER_S,
                HASH_OPS * p * bits / INT32_OP_PER_S)
    bms, by = bound(4.0 * m * p + 4.0 * m * bits, ops_s)
    return dict(**t, **order, max_abs_err=err.max().item(), bound_ms=bms,
                bound_by=by, call_peak_bytes=call_peak_bytes,
                launches=lsh_projection.KERNEL.launches - n0)


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


def same_bits(torch, a, b) -> bool:
    """Two exchange results equal bit for bit (NaN where NaN)."""
    return all(bool(torch.equal(x.nan_to_num(), z.nan_to_num())
                    and torch.equal(x.isnan(), z.isnan()))
               if x.is_floating_point() else bool(torch.equal(x, z))
               for x, z in zip(a, b))


def check_exchange(torch, m, n, r, c, gen, all_selected=False):
    """The one-shot kernel against `all_in_one_exchange_ref`, launched
    twice (bit-identical, else it raises), with its launch plan
    (`exchange.oneshot_plan`) and the plain version's peak allocation."""
    from repro_torch.kernels import exchange, ref
    own, nb, y, sel = exchange_inputs(torch, m, n, r, c, gen, all_selected)
    got = exchange.fused_exchange(own, nb, y, sel)
    kl, kv, kt, kh = got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pl, pv, pt, ph = ref.all_in_one_exchange_ref(own, nb, y, sel)
    torch.cuda.synchronize()
    plain_peak_bytes = torch.cuda.max_memory_allocated() - base
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    if not (torch.equal(kv, pv) and torch.equal(kh, ph)):
        raise AssertionError(f"exchange masks disagree at {(m, n, r, c)}")
    err = max((kl - pl).abs().max().item(), (kt - pt).abs().max().item())
    del pl, pv, pt, ph
    if not same_bits(torch, got, exchange.fused_exchange(own, nb, y, sel)):
        raise AssertionError(f"two exchange launches differ at "
                             f"{(m, n, r, c)}")
    n0 = exchange.KERNEL.launches
    t = timings(lambda: exchange.fused_exchange(own, nb, y, sel),
                ("fused_exchange_kernel",),
                lambda: ref.all_in_one_exchange_ref(own, nb, y, sel),
                plain_iters=3 if m >= 4096 else 20)
    bms, by = exchange_bound(m, n, r, c)
    return dict(**t, plan=exchange.oneshot_plan(m, n, r, c),
                repeat_bit_equal=True, plain_peak_bytes=plain_peak_bytes,
                max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=exchange.KERNEL.launches - n0)


def check_exchange_streamed(torch, m, n, r, c, gen, all_selected=False):
    """The streamed kernel against `streamed_exchange_ref` and
    `all_in_one_exchange_ref`; the one-shot kernel's device time at the
    same inputs is recorded beside it (`oneshot_ms`)."""
    from repro_torch.kernels import exchange, ref
    own, nb, y, sel = exchange_inputs(torch, m, n, r, c, gen, all_selected)
    got = exchange.fused_exchange_streamed(own, nb, y, sel)
    kl, kv, kt, kh = got
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
    if not same_bits(torch, got,
                     exchange.fused_exchange_streamed(own, nb, y, sel)):
        raise AssertionError(f"two streamed exchange launches differ at "
                             f"{(m, n, r, c)}")
    oneshot_ms = device_ms(lambda: exchange.fused_exchange(own, nb, y, sel),
                           ("fused_exchange_kernel",))
    n0 = exchange.STREAMED_KERNEL.launches
    t = timings(lambda: exchange.fused_exchange_streamed(own, nb, y, sel),
                streamed_exchange_names(exchange, m, n, r, c),
                lambda: ref.streamed_exchange_ref(own, nb, y, sel),
                plain_iters=2 if c > 8192 else 20)
    bms, by = exchange_bound(m, n, r, c)
    return dict(**t, oneshot_ms=oneshot_ms,
                plan=exchange.streamed_plan(m, n, r, c),
                repeat_bit_equal=True,
                two_read_floor_ms=bms + 1e3 * 4.0 * m * n * r * c
                / HBM_BYTES_PER_S,
                max_abs_err=err, bound_ms=bms, bound_by=by,
                launches=exchange.STREAMED_KERNEL.launches - n0)


def clustered_codes(torch, m, bits, gen, per_cluster=32, flip=0.02):
    """Codes of a converging federation: cluster centres of `per_cluster`
    clients each, every client's bits flipped with probability `flip`
    (the JAX ANN tests' regime), and Eq. 7-like scores concentrated in
    [0.75, 1] (distance-dominated Eq. 8)."""
    from repro_torch.kernels import ops
    centers = torch.rand((max(m // per_cluster, 1), bits), generator=gen,
                         device="cuda") < 0.5
    assign = torch.randint(0, centers.shape[0], (m,), generator=gen,
                           device="cuda")
    flips = torch.rand((m, bits), generator=gen, device="cuda") < flip
    codes = ops.pack_bits((centers[assign] ^ flips).float() * 2 - 1)
    scores = 0.75 + 0.25 * torch.rand(m, generator=gen, device="cuda")
    return codes, scores


def ann_inputs(torch, m, bits, n, gen, kind, prefix_bits=10, probes=8):
    """Codes, scores and the `ann_candidates` of one selection (seed 0):
    kind "random" (gridded scores), "ties" (all scores 0, round 0) or
    "clustered"."""
    from repro_torch.core import ann
    if kind == "clustered":
        codes, scores = clustered_codes(torch, m, bits, gen)
    else:
        codes, scores = selection_inputs(torch, m, bits, gen,
                                         ties=kind == "ties")
    cand = ann.ann_candidates(codes, scores, seed=0, prefix_bits=prefix_bits,
                              probes=probes, num_neighbors=min(n, m - 1))
    return codes, scores, cand


def ann_bound(cand_ids, m, w, n):
    """Codes, scores, table and candidate ids read once, the (M, N)
    outputs written once; 3*W integer operations (XOR, popcount, add)
    per valid candidate that is not the row itself, counted on these
    candidates."""
    import torch
    k = cand_ids.shape[1]
    nsel = min(n, m - 1)
    rows = torch.arange(m, device=cand_ids.device)[:, None]
    valid = int(((cand_ids < m) & (cand_ids != rows)).sum())
    bytes_moved = (4.0 * (m * w + m + m * k + w * 32 + 1)
                   + 8.0 * m * nsel)
    return bound(bytes_moved, 3.0 * valid * w / INT32_OP_PER_S)


def check_selection_ann(torch, m, bits, n, gen, kind="random",
                        prefix_bits=10, probes=8):
    """The ANN kernel against `ann_select_ref` on the same candidates;
    with prefix_bits=0 also against the one-shot exact kernel, whose
    device time is recorded beside it (`oneshot_ms`)."""
    from repro_torch.kernels import ref, selection
    codes, scores, cand = ann_inputs(torch, m, bits, n, gen, kind,
                                     prefix_bits, probes)
    lut = ref.selection_lut(bits // 32, bits, 1.0, device=codes.device)
    call = lambda: selection.fused_select_ann(     # noqa: E731
        codes, scores, cand.ids, bits=bits, gamma=1.0, num_neighbors=n)
    plain = lambda: ref.ann_select_ref(            # noqa: E731
        codes, scores, cand.ids, lut, num_neighbors=n)
    ki, kw = call()
    pi, pw = plain()
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and torch.equal(kw, pw)):
        raise AssertionError(f"ANN selection disagrees with its plain "
                             f"version at m={m}, kind={kind}")
    out = {"k": cand.ids.shape[1], "oneshot_ms": None}
    if prefix_bits == 0:
        oi, ow = selection.fused_select(codes, scores, bits=bits, gamma=1.0,
                                        num_neighbors=n)
        torch.cuda.synchronize()
        if not (torch.equal(ki, oi) and torch.equal(kw, ow)):
            raise AssertionError(f"ANN selection with prefix_bits=0 differs "
                                 f"from the one-shot kernel at m={m}")
        out["oneshot_ms"] = device_ms(lambda: selection.fused_select(
            codes, scores, bits=bits, gamma=1.0, num_neighbors=n),
            ("fused_select_kernel",))
    n0 = selection.ANN_KERNEL.launches
    t = timings(call, ("select_ann_kernel",), plain,
                plain_iters=1 if m > 8192 else (3 if m >= 1024 else 20))
    bms, by = ann_bound(cand.ids, m, bits // 32, n)
    return dict(**t, **out, max_abs_err=max_finite_diff(kw, pw), bound_ms=bms,
                bound_by=by, launches=selection.ANN_KERNEL.launches - n0)


def check_lsh_single(torch, p, bits, gen):
    """The single-client kernel against its plain version and the order
    twin, and its sums against the batched kernel's row on the same
    vector (`batched_equal`: bit for bit)."""
    from repro_torch.kernels import lsh_projection, ops, ref
    x = torch.randn((p,), generator=gen, device="cuda") * 0.05
    k = lsh_projection.lsh_project_sums(x, 7, bits=bits)
    pl = ref.lsh_project_sums_ref(x, 7, bits=bits)
    row = lsh_projection.lsh_project_sums_batched(x[None], 7, bits=bits)[0]
    torch.cuda.synchronize()
    err = (k - pl).abs()
    if not bool((err <= 1e-5 * (pl.abs() + x.norm())).all()):
        raise AssertionError(f"lsh_single sums disagree: max err "
                             f"{err.max().item()}")
    off_zero = pl.abs() > 1e-3
    if not torch.equal((k > 0)[off_zero], (pl > 0)[off_zero]):
        raise AssertionError("lsh_single code bits disagree off zero")
    order = lsh_order(torch, x[None], k, bits)
    n0 = lsh_projection.SINGLE_KERNEL.launches
    r = ops.rademacher_block(0, p, bits, 7, device="cuda")
    t = timings(lambda: lsh_projection.lsh_project_sums(x, 7, bits=bits),
                LSH_NAMES,
                lambda: ref.lsh_project_sums_ref(x, 7, bits=bits),
                library_fn=lambda: torch.matmul(x, r), plain_iters=5)
    del r
    ops_s = max(2.0 * p * bits / F32_FLOP_PER_S,
                HASH_OPS * p * bits / INT32_OP_PER_S)
    bms, by = bound(4.0 * p + 4.0 * bits, ops_s)
    if not torch.equal(k, row):
        raise AssertionError("lsh_single sums differ from the batched row")
    return dict(**t, **order, max_abs_err=err.max().item(), bound_ms=bms,
                bound_by=by, batched_equal=True,
                launches=lsh_projection.SINGLE_KERNEL.launches - n0)


def check_hamming(torch, m, bits, gen):
    """All pairs of one code set, as `lsh.distance_matrix` computes them,
    against the plain version; `library_ms` is torch.cdist(p=0) on the
    unpacked bits as float (counts the differing bits; unpacking not
    timed). `path` is the launch's path (small or tiled, chosen by M*N
    in the C entry point); `popc_floor_ms` the M*M*W popcounts at 16 per
    SM per clock."""
    from repro_torch.kernels import hamming, ops, ref
    w = bits // 32
    path = hamming.launch_path(m, m)
    codes, _ = selection_inputs(torch, m, bits, gen, ties=True)
    codes[1] = codes[0]
    k = hamming.hamming_all_pairs(codes, codes)
    pl = ref.hamming_all_pairs_ref(codes, codes)
    torch.cuda.synchronize()
    if not torch.equal(k, pl):
        raise AssertionError(f"hamming disagrees at m={m}, bits={bits}")
    del k, pl
    unpacked = ops.unpack_bits(codes, bits).float()
    n0 = hamming.KERNEL.launches
    t = timings(lambda: hamming.hamming_all_pairs(codes, codes),
                (f"hamming_{path}_kernel",),
                lambda: ref.hamming_all_pairs_ref(codes, codes),
                library_fn=lambda: torch.cdist(unpacked, unpacked, p=0),
                plain_iters=2 if m > 8192 else 20)
    bms, by = bound(4.0 * (2 * m * w + m * m), 3.0 * m * m * w
                    / INT32_OP_PER_S)
    return dict(**t, max_abs_err=0.0, bound_ms=bms, bound_by=by,
                popc_floor_ms=m * m * w / POPC_PER_S * 1e3, path=path,
                launches=hamming.KERNEL.launches - n0)


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the attention must score: all of them, or with
    the top-left causal mask sum_i min(i + 1, Sk) (S(S+1)/2 at Sq = Sk)."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + (sq - full) * sk


def check_flash(torch, n, sq, sk, dh, causal, dtype, gen, heads=None):
    """The flash-attention kernel against its plain version on unit-normal
    (N, S, dh) inputs, or with `heads` = (H, KV) on the model's (B, S, H,
    dh) / (B, S, KV, dh) layout through `ops.gqa_flash_attention` (N = B
    then). `library_ms`: torch's scaled_dot_product_attention on the same
    tensors, as a (1, N, S, dh) view (for the GQA layout heads moved next
    to the batch, KV heads repeated); `library_max_abs_err` its distance
    from the plain version. Bound: q, k, v and out once; 4 * N * H *
    pairs * dh operations on the kernel's route, the tensor cores: f32 by
    3xTF32 at a third of the TF32 rate, bf16 at the bf16 rate
    (`cuda_core_bound_ms`: the same operations at the f32 CUDA-core
    rate, the bound of the earlier CUDA-core kernel)."""
    from repro_torch.kernels import flash_attention, ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if heads is None:
        q, k, v = (torch.randn((n, s, dh), generator=gen, device="cuda")
                   .to(dtype) for s in (sq, sk, sk))
        call = lambda: flash_attention.flash_attention(  # noqa: E731
            q, k, v, causal=causal)
        plain = lambda: ref.flash_attention_ref(          # noqa: E731
            q, k, v, causal=causal)
        # the (1, N, S, dh) view: on 3-D tensors SDPA takes its math path
        lib = lambda: sdpa(q[None], k[None], v[None],     # noqa: E731
                           is_causal=causal)[0]
        h, kvh = 1, 1
    else:
        h, kvh = heads
        q = torch.randn((n, sq, h, dh), generator=gen, device="cuda")
        k, v = (torch.randn((n, sk, kvh, dh), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        call = lambda: ops.gqa_flash_attention(           # noqa: E731
            q, k, v, causal=causal)
        plain = lambda: ops.gqa_flash_attention(          # noqa: E731
            q, k, v, causal=causal, use_kernel=False)
        qh = q.movedim(2, 1)
        kh, vh = (t.movedim(2, 1).repeat_interleave(h // kvh, dim=1)
                  for t in (k, v))
        lib = lambda: sdpa(                               # noqa: E731
            qh, kh, vh, is_causal=causal).movedim(1, 2)
    o, pl, lo = call(), plain(), lib()
    torch.cuda.synchronize()
    err = (o.float() - pl.float()).abs().max().item()
    lib_err = (lo.float() - pl.float()).abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    if not err < tol:
        raise AssertionError(f"flash attention disagrees at "
                             f"{(n, sq, sk, dh, causal, dtype, heads)}: "
                             f"max abs err {err}")
    del o, pl, lo
    n0 = flash_attention.KERNEL.launches
    t = timings(call, ("flash_fwd_kernel",), plain, library_fn=lib)
    size = q.element_size()
    flop = 4.0 * n * h * attention_pairs(sq, sk, causal) * dh
    rate = F32_3XTF32_FLOP_PER_S if dtype == torch.float32 \
        else BF16_FLOP_PER_S
    bms, by = bound(size * (2.0 * q.numel() + 2.0 * k.numel()), flop / rate)
    return dict(**t, max_abs_err=err, library_max_abs_err=lib_err,
                bound_ms=bms, bound_by=by,
                cuda_core_bound_ms=flop / F32_FLOP_PER_S * 1e3,
                launches=flash_attention.KERNEL.launches - n0)


def profile_steps(torch, fn, iters: int = 3):
    """fn() `iters` times under torch.profiler after one warm-up call:
    host ms per call (device synchronised), device busy ms per call,
    idle share, device launches per call and the five costliest device
    kernels (ms per call)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name = Counter()
    dev = [e for e in prof.events() if is_device_work(e, DeviceType)]
    for e in dev:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3 / iters
    busy = sum(by_name.values())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_launches": len(dev) / iters,
            "top_device_ms": by_name.most_common(5)}


def serve_path(torch, kernels):
    """Path 4: Minitron-4B served at full width on the card, through the
    flash-attention kernel and then, on the same weights, through the
    naive attention; returns the kernel run's launch counts."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention
    from repro_torch.train import make_prefill_step, make_serve_step
    arch, kw = "minitron-4b", dict(reduced=False, batch=4, prompt_len=2048,
                                   max_new=32, seed=0, device="cuda")
    cfg = get_config(arch)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve(arch, **kw)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "main_path_launches", "run": "serve", **launches})
    if launches["flash_attention"] != cfg.num_layers or \
            any(v for name, v in launches.items()
                if name != "flash_attention"):
        raise AssertionError(f"the serving path must launch flash_attention "
                             f"{cfg.num_layers} times and nothing else: "
                             f"{launches}")
    logits, gen = res["logits"], res["generated"]
    if not (bool(logits.isfinite().all()) and gen.shape == (4, 32)
            and logits.shape == (32, 4, cfg.vocab_size)):
        raise AssertionError("serve gave non-finite logits or wrong shapes")

    for k in kernels.values():
        k.launches = 0
    attention.set_attn_impl("naive")
    try:
        naive = serve(arch, params=res["params"], **kw)
    finally:
        attention.set_attn_impl("auto")
    if kernels["flash_attention"].launches != 0:
        raise AssertionError("the naive run launched the kernel")
    lg_err = (logits[0] - naive["logits"][0]).abs().max().item()
    torch.testing.assert_close(logits[0], naive["logits"][0], rtol=1e-4,
                               atol=1e-4)
    top2 = naive["logits"].topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1] <= 1e-3).any(dim=1)   # per step
    differ = (gen != naive["generated"]).any(axis=0)
    first_near = int(near.nonzero()[0]) if bool(near.any()) else None
    first_diff = int(differ.nonzero()[0][0]) if differ.any() else None
    if first_diff is not None and (first_near is None
                                   or first_diff < first_near):
        raise AssertionError(f"served tokens differ from the naive run at "
                             f"step {first_diff} (first near-tie: "
                             f"{first_near})")

    # the kernel's device time in one profiled prefill, then decode steps
    prompts = {"tokens": torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 2048)), device="cuda")}
    step = make_prefill_step(cfg, cache_len=2048 + 32)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        _, cache = step(res["params"], prompts)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if is_device_work(e, DeviceType)]
    flash = [e.time_range.elapsed_us() / 1e3 for e in dev
             if "flash_fwd_kernel" in e.name]
    serve_step = make_serve_step(cfg)
    tok = torch.as_tensor(gen[:, 0], device="cuda")
    with torch.no_grad():
        decode = profile_steps(torch, lambda: serve_step(
            res["params"], cache, tok, 2048))
    emit({"phase": "serve", "arch": arch, "num_layers": cfg.num_layers,
          "d_model": cfg.d_model, "batch": 4, "prompt_len": 2048,
          "max_new": 32, "prefill_s": res["prefill_s"],
          "decode_tok_per_s": res["decode_tok_per_s"],
          "naive_prefill_s": naive["prefill_s"],
          "naive_decode_tok_per_s": naive["decode_tok_per_s"],
          "peak_memory_bytes": peak,
          "prefill_logits_max_abs_diff_vs_naive": lg_err,
          "tokens_equal_to_naive": first_diff is None,
          "first_differing_step": first_diff,
          "first_naive_near_tie_step": first_near,
          "flash_device_ms_in_prefill": sum(flash),
          "flash_launches_in_profile": len(flash),
          "prefill_device_ms": sum(e.time_range.elapsed_us() for e in dev)
          / 1e3,
          "decode_step_profile": decode,
          "sample": gen[0][:8].tolist()})
    return launches


def profile_round(run_federation, names, tiling: str = "auto",
                  backend: str = "kernel", round_idx: int = 1):
    """Profile an mnist federation under `backend` ("kernel" or "ann")
    and `tiling` and break round
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
        run_federation("mnist", rounds=round_idx + 1, backend=backend,
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
    return {"backend": backend, "tiling": tiling, "round": round_idx,
            "wall_ms": wall, "phases_ms": dict(phases),
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_phase": dict(dev_phase),
            "device_launches": len(device),
            "ported_kernels_ms": sum(v for k, v in by_name.items()
                                     if any(n in k for n in names)),
            "top_device_ms": by_name.most_common(5)}


def ptxas_summary(log: str) -> list:
    """`nvcc -Xptxas -v` output as one line per kernel: its mangled
    symbol, then its registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {spill}")
            name = None
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_main_path(run_federation, kernels, **kw):
    """Two mnist rounds on the card, with every kernel's launch count set
    to 0 just before and read just after; emits one line per round and
    returns (history, launches, final state)."""
    for k in kernels.values():
        k.launches = 0
    state, hist = run_federation("mnist", rounds=2, device="cuda", log=None,
                                 **kw)
    launches = {name: k.launches for name, k in kernels.items()}
    for h in hist:
        emit({"phase": "main_path", **kw, "round": h["round"],
              "acc": h["acc"], "mean_loss": h["mean_loss"],
              "seconds": h["seconds"]})
    return hist, launches, state


def expect_launches(launches, used, unused, label):
    """Every kernel of `used` launched at least once, none of `unused`."""
    emit({"phase": "main_path_launches", "run": label, **launches})
    missing = [name for name in used if launches[name] == 0]
    stray = [name for name in unused if launches[name] != 0]
    if missing or stray:
        raise AssertionError(f"{label} run launched no {missing} kernel "
                             f"and {stray} kernels it must not")


def expect_same_run(hist, base, label, id_sets=False):
    """Round-0 selection and masks equal (with `id_sets`: each row's set
    of ids), accuracy within 0.02 per round, finite losses."""
    if id_sets:
        same = [set(a) for a in hist[0]["neighbor_ids"]] == \
            [set(b) for b in base[0]["neighbor_ids"]]
    else:
        same = hist[0]["neighbor_ids"] == base[0]["neighbor_ids"] and \
            hist[0]["valid_mask"] == base[0]["valid_mask"]
    if not same:
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


def mnist_fed(backend: str = "kernel", **kw):
    """The FedConfig `run_federation("mnist", ...)` builds at its
    defaults (10 clients, N=12 clamped to 9)."""
    from repro_torch.configs.paper_models import (FedConfig,
                                                  PAPER_FED_OPTIMA)
    n_opt, alpha, gamma = PAPER_FED_OPTIMA["mnist"]
    return FedConfig(num_clients=10, num_neighbors=n_opt, alpha=alpha,
                     gamma=gamma, selection_backend=backend,
                     exchange_backend="kernel", **kw)


def check_ann_round0_order(torch, hist):
    """The ANN run's round-0 ids in order: `ann_select_ref` on the round-0
    codes (the initial state's, rebuilt as `run_federation` builds it)
    and the round's scores, candidates from `ann_candidates` seeded with
    round 0."""
    from repro_torch.core import ann, init_state
    from repro_torch.kernels import ref
    from repro_torch.launch.fed import MODEL_FOR
    from repro_torch.models.client import init_client_model
    from repro_torch.optim import adam
    fed = mnist_fed("ann")
    mcfg = MODEL_FOR["mnist"]()
    st = init_state(lambda g: init_client_model(mcfg, g, "cuda"),
                    adam(fed.lr), fed, 0)
    scores = torch.tensor(hist[0]["ranking_scores"], device="cuda")
    n = min(fed.num_neighbors, fed.num_clients - 1)
    cand = ann.ann_candidates(st.codes, scores, seed=0,
                              prefix_bits=fed.ann_prefix_bits,
                              probes=fed.ann_probes, num_neighbors=n)
    lut = ref.selection_lut(st.codes.shape[1], fed.lsh_bits, fed.gamma,
                            device="cuda")
    ids, _ = ref.ann_select_ref(st.codes, scores, cand.ids, lut,
                                num_neighbors=n)
    emit({"phase": "ann_round0_order", "k": cand.ids.shape[1],
          "ids": ids.tolist()})
    if ids.tolist() != hist[0]["neighbor_ids"]:
        raise AssertionError("round-0 ids of the ANN run differ from "
                             "ann_select_ref on the round-0 codes")


def check_auto_ann_at_scale(torch, gen, m=65_536, bits=256, n=16):
    """Path 2: `select_partners(backend="auto")` at M=65,536 on clustered
    codes must launch the ANN kernel once and no exact selection kernel,
    and give `ann_select_ref`'s ids on the same candidates. Reports K,
    the occupancy, the candidate generation's and the kernel's time, the
    whole ANN selection's, and recall@N against the tiled exact kernel on
    the same inputs (device time; the profiler may drop records of the
    15 ms tiled kernel, so its CUDA-event call time is printed too)."""
    from repro_torch.configs.paper_models import FedConfig
    from repro_torch.core import ann
    from repro_torch.core.neighbor import select_partners
    from repro_torch.kernels import ref, selection
    codes, scores = clustered_codes(torch, m, bits, gen)
    fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits)
    kernels = (selection.ANN_KERNEL, selection.KERNEL, selection.TILED_KERNEL)
    before = [k.launches for k in kernels]
    ids, mask = select_partners(codes, scores, fed, backend="auto", seed=0)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    gen_cand = lambda: ann.ann_candidates(         # noqa: E731
        codes, scores, seed=0, prefix_bits=fed.ann_prefix_bits,
        probes=fed.ann_probes, num_neighbors=n)
    cand = gen_cand()
    lut = ref.selection_lut(bits // 32, bits, fed.gamma, device="cuda")
    want, _ = ref.ann_select_ref(codes, scores, cand.ids, lut,
                                 num_neighbors=n)
    kernel = lambda: selection.fused_select_ann(   # noqa: E731
        codes, scores, cand.ids, bits=bits, gamma=fed.gamma, num_neighbors=n)
    tiled = lambda: selection.fused_select_tiled(  # noqa: E731
        codes, scores, bits=bits, gamma=fed.gamma, num_neighbors=n)
    exact, _ = tiled()
    torch.cuda.synchronize()
    hits = (ids.long()[:, :, None] == exact.long()[:, None, :]).any(-1)
    out = {"phase": "auto_ann", "m": m, "bits": bits, "n": n,
           "ann_launches": launched[0], "oneshot_launches": launched[1],
           "tiled_launches": launched[2], **ann.occupancy_stats(cand),
           "recall_vs_tiled_exact": hits.float().mean().item(),
           "candidates_ms": time_ms(gen_cand, iters=5),
           "kernel_ms": device_ms(kernel, ("select_ann_kernel",)),
           "select_partners_ms": time_ms(lambda: select_partners(
               codes, scores, fed, backend="auto", seed=0), iters=5),
           "tiled_exact_call_ms": time_ms(tiled, iters=5),
           "tiled_exact_ms": device_ms(tiled, ("select_tiled_kernel",),
                                       iters=5)}
    emit(out)
    if launched != [1, 0, 0] or not torch.equal(ids, want) or \
            not bool(mask.all()):
        raise AssertionError(f"select_partners(backend='auto') at M={m} did "
                             f"not take the ANN kernel: {launched}")


def client_codes_and_distances(torch, state, kernels):
    """Path 3 on the one-shot run's final state, with every launch count
    set to 0 just before and read just after: each client's own code
    through the single-client kernel against its row of the published
    codes, and the unfused Eq. 6-8 composition through the Hamming kernel
    against the fused one-shot kernel's ids on the same codes and scores
    (equal, except where two Eq. 8 weights are within 1 ulp: the unfused
    weights run torch.exp on the card, the fused ones gather the table
    built on the CPU)."""
    from repro_torch.core import lsh, neighbor
    from repro_torch.core.protocol import client, select_phase
    from repro_torch.kernels import lsh_projection, ops
    fed = mnist_fed("kernel")
    for k in kernels.values():
        k.launches = 0
    own = torch.stack([lsh.client_lsh_code(client(state.params, i),
                                           state.round, bits=fed.lsh_bits)
                       for i in range(fed.num_clients)])
    sel = select_phase(state, fed)
    dn = lsh.normalized_distance(lsh.distance_matrix(state.codes),
                                 fed.lsh_bits)
    w = neighbor.selection_weights(sel.scores, dn, fed.gamma)
    ids_u, mask_u = neighbor.select_neighbors(w, fed.num_neighbors)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    # near-zero sums: the published (batched) codes' sums of the same rows
    flat = ops.flatten_params_batched(state.params)
    sums = lsh_projection.lsh_project_sums_batched(flat, state.round,
                                                   bits=fed.lsh_bits)
    near = sums.abs() <= 1e-3
    own_bits = ops.unpack_bits(own, fed.lsh_bits).bool()
    pub_bits = ops.unpack_bits(state.codes, fed.lsh_bits).bool()
    wf = torch.gather(w, 1, sel.ids.long())
    wu = torch.gather(w, 1, ids_u.long())
    ulps = (wf.view(torch.int32).long() - wu.view(torch.int32).long()).abs()
    same_ids = torch.equal(sel.ids, ids_u)
    emit({"phase": "client_codes_and_distances", **launches,
          "codes_equal_all_bits": bool(torch.equal(own, state.codes)),
          "near_zero_bits": int(near.sum()),
          "unfused_ids_equal": same_ids,
          "max_weight_ulps_where_ids_differ": int(ulps.max())})
    if not torch.equal(own_bits[~near], pub_bits[~near]):
        raise AssertionError("client_lsh_code differs from the published "
                             "codes off near-zero sums")
    if not (same_ids or int(ulps.max()) <= 1) or not bool(mask_u.all()):
        raise AssertionError("the unfused Eq. 6-8 selection differs from "
                             "the fused kernel's beyond 1-ulp near-ties")
    if launches["lsh_single"] != fed.num_clients or \
            launches["hamming"] != 1:
        raise AssertionError(f"path 3 did not launch lsh_single "
                             f"{fed.num_clients} times and hamming once: "
                             f"{launches}")
    return launches


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
    from repro_torch.kernels import (build, exchange, flash_attention,
                                     hamming, lsh_projection, selection)
    from repro_torch.launch.fed import run_federation

    resolve_device("cuda")               # strict f32: TF32 off
    kernels = {"lsh_projection": lsh_projection.KERNEL,
               "selection": selection.KERNEL, "exchange": exchange.KERNEL,
               "selection_tiled": selection.TILED_KERNEL,
               "exchange_streamed": exchange.STREAMED_KERNEL,
               "selection_ann": selection.ANN_KERNEL,
               "lsh_single": lsh_projection.SINGLE_KERNEL,
               "hamming": hamming.KERNEL,
               "flash_attention": flash_attention.KERNEL}
    t0 = time.perf_counter()
    logs = build.build_all(kernels.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: ptxas_summary(log)
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
        ("lsh_projection", dict(m=35, p=12_288, bits=256), False,
         lambda: check_lsh(torch, 35, 12_288, 256, gen)),
        ("lsh_projection", dict(m=4096, p=12_288, bits=256), False,
         lambda: check_lsh(torch, 4096, 12_288, 256, gen)),
        ("lsh_projection", dict(m=65_536, p=12_288, bits=256), False,
         lambda: check_lsh(torch, 65_536, 12_288, 256, gen)),
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
    ] + [
        ("exchange", dict(m=m, n=n, r=r, c=c), False,
         lambda m=m, n=n, r=r, c=c: check_exchange(torch, m, n, r, c, gen))
        for m, n, r, c in ((8, 16, 64, 1024), (4096, 16, 64, 10),
                           (65_536, 16, 64, 10))
    ] + [
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
    ] + [
        ("selection_ann", dict(m=10, bits=256, n=9, k=100), True,
         lambda: check_selection_ann(torch, 10, 256, 9, gen)),
        ("selection_ann", dict(m=10, bits=256, n=9, k=100, ties=True), False,
         lambda: check_selection_ann(torch, 10, 256, 9, gen, kind="ties")),
        ("selection_ann", dict(m=4096, bits=256, n=16, clustered=True), False,
         lambda: check_selection_ann(torch, 4096, 256, 16, gen,
                                     kind="clustered")),
        ("selection_ann", dict(m=65_536, bits=256, n=16, clustered=True),
         False, lambda: check_selection_ann(torch, 65_536, 256, 16, gen,
                                            kind="clustered")),
        ("selection_ann", dict(m=4096, bits=256, n=16, prefix_bits=0), False,
         lambda: check_selection_ann(torch, 4096, 256, 16, gen,
                                     prefix_bits=0, probes=0)),
    ] + [
        ("lsh_single", dict(p=p, bits=256), p == 421_888,
         lambda p=p: check_lsh_single(torch, p, 256, gen))
        for p in (421_888, 4096, 8192, 12_288)
    ] + [
        ("hamming", dict(m=m, bits=256), m == 10,
         lambda m=m: check_hamming(torch, m, 256, gen))
        for m in (10, 1024, 16_384)
    ] + [
        ("flash_attention", dict(n=n, sq=sq, sk=sk, dh=dh, causal=causal,
                                 dtype=str(dt)[6:], **extra),
         extra == {} and (n, sq, dh, dt) == (96, 2048, 128, torch.float32),
         lambda n=n, sq=sq, sk=sk, dh=dh, causal=causal, dt=dt, extra=extra:
         check_flash(torch, n, sq, sk, dh, causal, dt, gen, **extra))
        for n, sq, sk, dh, causal, dt, extra in (
            (96, 2048, 2048, 128, True, torch.float32, {}),
            (96, 2048, 2048, 128, True, torch.bfloat16, {}),
            (2, 512, 512, 128, True, torch.float32, {}),
            (1, 1024, 512, 64, True, torch.float32, {}),
            (2, 256, 512, 128, False, torch.float32, {}),
            (3, 1000, 1000, 128, True, torch.float32, {}),
            (2, 512, 512, 128, True, torch.bfloat16, {}),
            (2, 512, 512, 256, True, torch.float32, {}),
            (4, 2048, 2048, 128, True, torch.float32,
             {"heads": (24, 8)}))
    ]
    for name, shape, is_main, run in checks:
        res = run()
        emit({"phase": "kernel_check", "kernel": name, "shape": shape,
              "main_path_shape": is_main, **res})
        if is_main:
            main_shape[name] = res
        torch.cuda.empty_cache()

    # 3. the main paths: one-shot kernels, plain versions, tiled kernels,
    # ANN selection; then the per-client code and the unfused Eq. 6-8
    oneshot = ("lsh_projection", "selection", "exchange")
    tiled = ("lsh_projection", "selection_tiled", "exchange_streamed")
    ann_path = ("lsh_projection", "selection_ann", "exchange")
    hist, launches, state = run_main_path(run_federation, kernels,
                                          backend="kernel")
    expect_launches(launches, oneshot, set(kernels) - set(oneshot),
                    "one-shot")
    hist_o, _, _ = run_main_path(run_federation, kernels, backend="oracle")
    expect_same_run(hist_o, hist, "oracle")
    hist_t, launches_t, _ = run_main_path(run_federation, kernels,
                                          backend="kernel", tiling="tiled")
    expect_launches(launches_t, tiled, set(kernels) - set(tiled), "tiled")
    expect_same_run(hist_t, hist, "tiled")
    hist_a, launches_a, _ = run_main_path(run_federation, kernels,
                                          backend="ann")
    expect_launches(launches_a, ann_path, set(kernels) - set(ann_path), "ann")
    if launches_a["selection_ann"] != 2:
        raise AssertionError("the ann run launched the ANN selection "
                             f"{launches_a['selection_ann']} times, not 2")
    expect_same_run(hist_a, hist, "ann", id_sets=True)
    check_ann_round0_order(torch, hist_a)
    launches_c = client_codes_and_distances(torch, state, kernels)
    for name in ("selection_tiled", "exchange_streamed"):
        launches[name] = launches_t[name]
    launches["selection_ann"] = launches_a["selection_ann"]
    for name in ("lsh_single", "hamming"):
        launches[name] = launches_c[name]
    check_auto_tiling_at_scale(torch, gen)
    check_auto_ann_at_scale(torch, gen)

    names = (*LSH_NAMES, "fused_select_kernel",
             "fused_exchange_kernel", "select_tiled_kernel",
             *STREAMED_EXCHANGE_NAMES, "select_ann_kernel")
    for backend, tiling in (("kernel", "oneshot"), ("kernel", "tiled"),
                            ("ann", "auto")):
        emit({"phase": "profile", **profile_round(
            run_federation, names, tiling=tiling, backend=backend)})

    # 4. LM serving: Minitron-4B at full width, prefill + greedy decode
    launches["flash_attention"] = serve_path(torch, kernels)[
        "flash_attention"]

    # 5. every ported kernel
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
        "selection_ann": ("src/repro_torch/kernels/csrc/selection_ann.cu",
                          "src/repro/kernels/selection.py:398"),
        "lsh_single": ("src/repro_torch/kernels/csrc/lsh_projection.cu",
                       "src/repro/kernels/lsh_projection.py:92"),
        "hamming": ("src/repro_torch/kernels/csrc/hamming.cu",
                    "src/repro/kernels/hamming.py:52"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:90"),
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

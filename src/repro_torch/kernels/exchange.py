"""Fused all-in-one exchange (WPFed Eq. 3 + §3.5 + target): wrappers of the
one-shot and the streamed CUDA kernels, and their launch plans.

`fused_exchange` replaces the TPU kernel
`repro/kernels/exchange.py:fused_exchange` (`_exchange_kernel`) with
`csrc/exchange.cu`: one launch in which a thread-block cluster of up to
8 CTAs takes a client, each CTA a contiguous piece of its flattened
(n, r) rows. One shared neighbour log-softmax per row feeds the Eq. 3
label NLL and the §3.5 KL; the per-neighbour means meet through
distributed shared memory; the upper-half mask is the stable counting
rank; the masked target mean follows in the same launch. Where a
client's rows and own logits fit in shared memory the CTAs bring them
in by TMA bulk copies and read the neighbour logits from device memory
once. It is bound on the H100 by those bytes: under a microsecond at
the main path's shapes, where the launch dominates. It takes N <= 512
(`MAX_THREADS`) and the (N, R) that `oneshot_smem_bytes` admits; which
(N, R) reach it is `backends.resolve_tiling`'s choice, from
`oneshot_smem_bytes` alone. `oneshot_plan` (cluster size, rows per CTA,
lanes per row, staging) is this wrapper's own choice and changes no
route.

`fused_exchange_streamed` replaces the TPU kernel
`repro/kernels/exchange.py:fused_exchange_streamed`
(`_streamed_stats_kernel` + `_target_kernel`) with
`csrc/exchange_streamed.cu`: partial statistics per (client, rows, C
chunk), the own chunk read once and the neighbour chunks streamed
against it (the neighbours split over warps only while the card would
be short of warps); the chunks merged in order (by a launch of their
own from 16 chunks a row), the means and the mask per client; the
target over (client, R*C tiles), or in the mask launch for R*C <= 4,096
(`streamed_plan`). Nothing bounds N, R or C but device memory. Bound by
bytes; it reads the neighbour logits twice (the valid ones in the
target pass), the floor where the mask lies between the statistics and
the target.

Each wrapper takes its plain version (`ref.all_in_one_exchange_ref`,
`ref.streamed_exchange_ref`) for CPU and `meta` tensors only
(`build.PLAIN_DEVICES`); for a CUDA tensor it launches its kernel or raises.
Both register with `analysis.registry.kernel_contract` (class
"tolerance": valid and has_target equal, l_ij and target within rtol
1e-5 one-shot and 2e-5 streamed, atol 1e-5; the mask may flip only on an
exact KL tie), the one-shot kernel with its shared-memory mirror
(`fused_exchange_smem_bytes` in `csrc/exchange.cu`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.registry import Estimator, kernel_contract
from repro_torch.kernels import ref
from repro_torch.kernels.build import (MAX_SHARED_BYTES, PLAIN_DEVICES,
                                       CudaKernel)

KERNEL = CudaKernel(
    "exchange", "exchange.cu", "fused_exchange",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
MAX_THREADS = 512           # the neighbour slots the one-shot kernel takes
# one-shot plan: the portable cluster size; the CTAs that fill the H100
# (four per SM of its 132); the fewest (n, r) rows worth a CTA of their own
CLUSTER_MAX = 8
FILL_CTAS = 4 * 132
MIN_ROWS = 32
# threads of a one-shot CTA, staged and not (csrc/exchange.cu: threads)
ONESHOT_THREADS = {True: 256, False: 512}


def oneshot_smem_bytes(n: int, r: int) -> int:
    """The one-shot route's shared-memory estimate, the figure
    `backends.resolve_tiling` compares with MAX_SHARED_BYTES: own-row
    max and LSE, per-(n, r) NLL and KL, per-neighbour KL mean and mask,
    of a client in one CTA (the kernel's unstaged layout at one CTA per
    client, its largest). Above MAX_THREADS neighbour slots the kernel
    cannot run at all: reported as one byte over MAX_SHARED_BYTES."""
    if n > MAX_THREADS:
        return MAX_SHARED_BYTES + 1
    return 4 * (2 * r + 2 * n * r + 2 * n)


def oneshot_layout_bytes(n: int, r: int, c: int, q: int, staged: bool,
                         lsh_verification: bool = True) -> int:
    """Dynamic shared memory of one `csrc/exchange.cu` CTA owning q rows
    (its `layout`): staged, a 16-byte head (the mbarrier), the q rows,
    logp_own and p_own (with verification), NLL and KL per row, KL mean
    and mask per neighbour; unstaged, own max and LSE per r instead of
    the slabs."""
    if staged:
        own = 2 * r * c if lsh_verification else 0
        return 4 * (4 + q * c + own + 2 * q + 2 * n)
    return 4 * (2 * r + 2 * q + 2 * n)


def lanes_per_row(c: int, q: int, threads: int) -> int:
    """Lanes of a warp that take one row of C logits in a one-shot CTA of
    q rows and `threads` threads: the power of two >= C / 16 (one lane a
    row up to C = 16, in fully unrolled loops), doubled while the CTA's
    rows leave half its threads idle and a lane keeps two columns; at
    most 32."""
    lanes = 1
    while lanes < 32 and (16 * lanes < c or (
            2 * lanes * q <= threads and 2 * lanes <= c)):
        lanes *= 2
    return lanes


def oneshot_plan(m: int, n: int, r: int, c: int,
                 lsh_verification: bool = True) -> dict:
    """The one-shot launch for an (M, N, R, C) exchange: `cluster` CTAs
    per client (up to CLUSTER_MAX while M alone leaves the card short of
    FILL_CTAS, and no more than MIN_ROWS rows each), `rows_per_cta` (q)
    consecutive (n, r) rows each (a multiple of 4 in a cluster, so each
    piece starts on 16 bytes for TMA), `staged`: whether the rows and own
    logits are held in shared memory (when that layout fits
    MAX_SHARED_BYTES), the CTA's `threads` and `lanes` per row.
    `smem_bytes` is the CTA's dynamic shared memory; unstaged it never
    passes `oneshot_smem_bytes(n, r)`."""
    rows = n * r
    cluster = max(1, min(CLUSTER_MAX, -(-FILL_CTAS // max(m, 1)),
                         -(-rows // MIN_ROWS)))
    q = -(-rows // cluster)
    if cluster > 1:
        q = -(-q // 4) * 4
    staged_bytes = oneshot_layout_bytes(n, r, c, q, True, lsh_verification)
    staged = staged_bytes <= MAX_SHARED_BYTES
    smem = staged_bytes if staged else oneshot_layout_bytes(
        n, r, c, q, False, lsh_verification)
    threads = ONESHOT_THREADS[staged]
    return {"cluster": cluster, "rows_per_cta": q,
            "lanes": lanes_per_row(c, q, threads), "staged": staged,
            "threads": threads, "smem_bytes": smem, "ctas": m * cluster}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on 16 bytes (the kernels read float4 and
    copy by TMA)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _checked(own_logits, neighbor_logits, y_ref, sel_mask):
    """Raise on what the kernels do not take; the inputs as the kernels
    read them (f32 / int32, contiguous, 16-byte aligned) and the outputs
    to fill: l_ij (M, N) f32, valid (M, N) int32, target (M, R, C) f32
    and a per-client int32."""
    dev = neighbor_logits.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    m, n, r, c = neighbor_logits.shape
    if own_logits.shape != (m, r, c) or y_ref.shape != (m, r) \
            or sel_mask.shape != (m, n):
        raise ValueError("shape mismatch: own (M, R, C), neighbour "
                         "(M, N, R, C), y_ref (M, R), sel (M, N)")
    if any(t.device != dev for t in (own_logits, y_ref, sel_mask)):
        raise ValueError("all exchange inputs must be on one device")
    inputs = (_aligned(own_logits.to(torch.float32)),
              _aligned(neighbor_logits.to(torch.float32)),
              y_ref.to(torch.int32).contiguous(),
              sel_mask.to(torch.int32).contiguous())
    outputs = (torch.empty((m, n), dtype=torch.float32, device=dev),
               torch.empty((m, n), dtype=torch.int32, device=dev),
               torch.empty((m, r, c), dtype=torch.float32, device=dev),
               torch.empty((m,), dtype=torch.int32, device=dev))
    return inputs, outputs


NEAR_TIES = "the §3.5 mask may flip on an exact KL tie"


def _contract_args(point: dict):
    """Seeded CPU inputs of a contract point: unit-normal logits, labels
    in [0, C), about three quarters of the slots selected."""
    g = torch.Generator().manual_seed(0)
    m, n, r, c = point["m"], point["n"], point["r"], point["c"]
    own = torch.randn((m, r, c), generator=g)
    nb = torch.randn((m, n, r, c), generator=g)
    y = torch.randint(0, c, (m, r), generator=g, dtype=torch.int32)
    sel = torch.rand((m, n), generator=g) < 0.75
    return (own, nb, y, sel), {"lsh_verification": True}


def _layout_args(point: dict):
    """`oneshot_layout_bytes` arguments of a point's plan, staged and not."""
    m, n, r, c = point["m"], point["n"], point["r"], point["c"]
    q = oneshot_plan(m, n, r, c)["rows_per_cta"]
    return [(n, r, c, q, staged, 1) for staged in (1, 0)]


@kernel_contract(
    kernel=KERNEL, stands_for="exchange_oneshot",
    twin="all_in_one_exchange_ref", exactness="tolerance", rtol=1e-5,
    atol=1e-5, near_ties=NEAR_TIES, helpers=("fused_exchange_smem_bytes",),
    estimators=(Estimator("fused_exchange_smem_bytes", oneshot_layout_bytes,
                          _layout_args),),
    points=({"m": 4, "n": 3, "r": 8, "c": 5},
            {"m": 10, "n": 9, "r": 64, "c": 10},
            {"m": 8, "n": 16, "r": 64, "c": 1024},
            {"m": 4096, "n": 16, "r": 64, "c": 10}),
    make_args=_contract_args)
def fused_exchange(own_logits: torch.Tensor, neighbor_logits: torch.Tensor,
                   y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                   lsh_verification: bool = True):
    """own (M, R, C), neighbour (M, N, R, C), y_ref (M, R), sel (M, N) ->
    (l_ij (M, N) f32, valid (M, N) bool, target (M, R, C) f32,
    has_target (M,) bool)."""
    if neighbor_logits.device.type in PLAIN_DEVICES:
        return ref.all_in_one_exchange_ref(own_logits, neighbor_logits,
                                           y_ref, sel_mask,
                                           lsh_verification=lsh_verification)
    (own, nb, y, sel), (l_ij, valid, target, has) = _checked(
        own_logits, neighbor_logits, y_ref, sel_mask)
    m, n, r, c = nb.shape
    if oneshot_smem_bytes(n, r) > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, R={r} exceed the one-shot kernel; "
                         "exchange with tiling=\"tiled\" or \"auto\" (the "
                         "streamed kernel)")
    if m == 0 or n == 0:
        return (l_ij, valid.bool(), target.zero_(), has.zero_().bool())
    plan = oneshot_plan(m, n, r, c, lsh_verification)
    KERNEL.launch(nb.device, own.data_ptr(), nb.data_ptr(), y.data_ptr(),
                  sel.data_ptr(), m, n, r, c, int(lsh_verification),
                  plan["cluster"], plan["rows_per_cta"], plan["lanes"],
                  int(plan["staged"]),
                  l_ij.data_ptr(), valid.data_ptr(), target.data_ptr(),
                  has.data_ptr())
    return l_ij, valid.bool(), target, has.bool()


STREAMED_KERNEL = CudaKernel(
    "exchange_streamed", "exchange_streamed.cu", "fused_exchange_streamed",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p])
# streamed plan: a lane's columns per chunk, short rows and long (rows
# take 16 a lane from STREAM_LONG_C on: 512-column chunks); the warps
# that fill the H100 (16 per SM of its 132), below which a warp's
# neighbours are split; the largest R*C whose target the mask launch
# writes itself, and the chunks from which rows are merged in a launch of
# their own (csrc/exchange_streamed.cu: FUSED_RC, MERGE_CHUNKS)
STREAM_ELEMS = (4, 16)
STREAM_LONG_C = 512
FILL_WARPS = 16 * 132
FUSED_RC = 4096
MERGE_CHUNKS = 16


def streamed_plan(m: int, n: int, r: int, c: int) -> dict:
    """The streamed launches for an (M, N, R, C) exchange: `elems`
    columns per lane and chunk, `lanes` per row (the power of two that
    covers C, at most 32), `chunks` of lanes * elems columns per row,
    `row_groups` of 32 / lanes rows per warp, the neighbours split into
    `groups` of `per_group` while (client, row group, chunk) warps alone
    leave the card short of FILL_WARPS, `units` (the warps of launch 1),
    `merged`: rows merged from their chunks by a launch of their own
    (chunks >= MERGE_CHUNKS), and `fused`: the target written by the
    mask launch (R * C <= FUSED_RC). The launches: statistics, [merge],
    mask, [target]."""
    elems = STREAM_ELEMS[1] if c >= STREAM_LONG_C else STREAM_ELEMS[0]
    lanes = 1
    while lanes < 32 and lanes * elems < c:
        lanes *= 2
    chunks = -(-c // (lanes * elems))
    row_groups = -(-r // (32 // lanes))
    base = m * row_groups * chunks
    groups = min(n, max(1, -(-FILL_WARPS // max(base, 1))))
    per_group = -(-n // groups)
    groups = -(-n // per_group)
    return {"lanes": lanes, "elems": elems, "chunks": chunks,
            "row_groups": row_groups, "groups": groups,
            "per_group": per_group, "units": base * groups,
            "merged": chunks >= MERGE_CHUNKS, "fused": r * c <= FUSED_RC}


@kernel_contract(
    kernel=STREAMED_KERNEL, stands_for="exchange_streamed",
    twin="streamed_exchange_ref", exactness="tolerance", rtol=2e-5,
    atol=1e-5, near_ties=NEAR_TIES,
    points=({"m": 4, "n": 3, "r": 8, "c": 600},), make_args=_contract_args)
def fused_exchange_streamed(own_logits: torch.Tensor,
                            neighbor_logits: torch.Tensor,
                            y_ref: torch.Tensor, sel_mask: torch.Tensor, *,
                            lsh_verification: bool = True):
    """`fused_exchange`'s contract through the streamed kernel, at any
    N, R, C: own (M, R, C), neighbour (M, N, R, C), y_ref (M, R),
    sel (M, N) -> (l_ij (M, N) f32, valid (M, N) bool, target (M, R, C)
    f32, has_target (M,) bool). l_ij and target agree with the plain
    versions within f32 rounding; valid and has_target are equal."""
    if neighbor_logits.device.type in PLAIN_DEVICES:
        return ref.streamed_exchange_ref(own_logits, neighbor_logits, y_ref,
                                         sel_mask,
                                         lsh_verification=lsh_verification)
    (own, nb, y, sel), (l_ij, valid, target, count) = _checked(
        own_logits, neighbor_logits, y_ref, sel_mask)
    m, n, r, c = nb.shape
    if min(m, n, r, c) == 0:
        return (l_ij, valid.bool(), target.zero_(), count.zero_().bool())
    plan = streamed_plan(m, n, r, c)
    k = plan["chunks"]
    # scratch: freed on return, but the caching allocator reuses a block
    # only in order on this stream, after the kernels that read it
    dev = nb.device
    part = torch.empty((m, n, r, k, 4), dtype=torch.float32, device=dev)
    own_part = torch.empty((m, r, k, 2), dtype=torch.float32, device=dev)
    rows_s = torch.empty((2, m, n, r) if plan["merged"] else (2, 0),
                         dtype=torch.float32, device=dev)
    klm_s = torch.empty((m, n), dtype=torch.float32, device=dev)
    STREAMED_KERNEL.launch(
        dev, own.data_ptr(), nb.data_ptr(), y.data_ptr(), sel.data_ptr(), m,
        n, r, c, int(lsh_verification), plan["lanes"], plan["elems"], k,
        plan["groups"], plan["per_group"], int(plan["fused"]),
        part.data_ptr(), own_part.data_ptr(), rows_s[0].data_ptr(),
        rows_s[1].data_ptr(), klm_s.data_ptr(),
        l_ij.data_ptr(), valid.data_ptr(), target.data_ptr(),
        count.data_ptr())
    return l_ij, valid.bool(), target, count > 0

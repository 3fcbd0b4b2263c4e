"""LSH projection (WPFed Eq. 5): wrappers of the batched and the
single-client CUDA kernels.

Replaces the TPU kernels `repro/kernels/lsh_projection.py:
lsh_project_sums_batched` (`_lsh_batched_kernel`) and
`repro/kernels/lsh_projection.py:lsh_project_sums` (`_lsh_kernel`, the
code one client computes from its own model). Both are one source,
`csrc/lsh_projection.cu`, which regenerates the +-1 projection matrix
on the chip from the hash of (parameter index, bit, seed), so R's bytes
are never moved.

The invariant: P is cut into S = P / L splits of L consecutive
parameters; each sum runs one f32 chain `acc = fmaf(r, x, acc)` from 0
in increasing p within a split, and the S split sums are added in order
k = 0..S-1 from 0 in f64, rounded to f32 once at the end. L =
`split_len(P)` depends on P alone, so a client's
own sums equal its row of the batched sums bit for bit at any M, and a
call gives the same sums every time. `ref.lsh_project_sums_split_order`
is that order in plain tensor operations; the tests and `chip_smoke.py`
hold every kernel instance to it with `torch.equal`.

The split plan: L is the largest of 128, 256, ..., 2048 that still
gives one split per SM of the H100 (P / L >= 132), else 128: 32 splits
of 128 at P = 4,096, splits of 2,048 from P = 270,336 on (mnist's
421,888). The C entry point then picks one of three instances of the
partial kernel from (M, bits, S): single row (M = 1, one thread per
bit), few rows (2 <= M < 64, TM in {4, 8, 16} rows in registers per
thread), many rows (M >= 64, 128 x 128 tiles of a 256-thread block,
8 x 8 accumulators per thread, R hashed once per block into shared
memory); `csrc/lsh_projection.cu` gives the tiles, shared memory and
bound. A second kernel adds the splits.

The partial sums of one launch, (S, rows, bits) f32, are bits / L times
the size of those rows of x (2x at L = 128, bits = 256). So the batched
wrapper launches its rows in consecutive groups whose partial sums fit
in PARTIAL_BYTES (512 MiB; groups of a multiple of 128 rows, at least
128), one scratch buffer reused by every group (`row_groups`). A row's
sums do not depend on the rows launched with it, so the groups change
no bit; each group is one launch of the C entry point.

The single-client entry point also takes a uint32 row offset i0: x is
then a shard of a longer vector that starts at global index i0, and its
entry p is hashed as row i0 + p of R, mod 2^32, as the JAX
`rademacher_block(i0, ...)` does (`core/lsh.py:sharded_lsh_code`). The
offset moves no split boundary and changes no order; i0 = 0 is the
unsharded call.

Each wrapper takes its plain version (`ref.lsh_project_sums_batched_ref`,
`ref.lsh_project_sums_ref`) for CPU and `meta` tensors only
(`build.PLAIN_DEVICES`); for a CUDA tensor it launches its kernel or raises.
Both register with `analysis.registry.kernel_contract` (class
"tolerance": sums within rtol 1e-5 and atol 4e-4 of the plain version,
1e-5 of the rows' norm at the contract shape; a code bit may differ only
where |sum| < 1e-3).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.registry import kernel_contract
from repro_torch.kernels import ref
from repro_torch.kernels.build import PLAIN_DEVICES, CudaKernel
from repro_torch.kernels.ops import CHUNK, MASK32

# Split lengths, longest first, and the SMs one split each should fill
# (the H100's 132; csrc/lsh_projection.cu plans its tiles with the same
# count as SMS, and tests/test_torch_lsh_split.py holds the two equal).
SPLIT_LENS = (2048, 1024, 512, 256, 128)
NUM_SMS = 132
# most bytes of partial sums one batched launch writes, and the row tile
# of the many-row instance that a group of rows is a multiple of
PARTIAL_BYTES = 512 << 20
ROW_TILE = 128
INSTANCES = ("single", "few", "many")

KERNEL = CudaKernel(
    "lsh_projection", "lsh_projection.cu", "lsh_project_sums_batched",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p])


SINGLE_KERNEL = CudaKernel(
    "lsh_single", "lsh_projection.cu", "lsh_project_sums",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p])


def projection_flops(m: int, p: int, bits: int) -> int:
    """The Eq. 5 sums' work as a product: 2 * M * P * bits FLOPs, x (M, P)
    against the +-1 matrix (P, bits) (its bound's f32 operations in
    chip_smoke.py; the hash that makes R runs on the integer pipe)."""
    return 2 * m * p * bits


def split_len(p: int) -> int:
    """L, the parameters per split, for a P that is a multiple of CHUNK:
    the longest of SPLIT_LENS with P / L >= NUM_SMS, else the shortest."""
    for length in SPLIT_LENS:
        if p // length >= NUM_SMS:
            return length
    return SPLIT_LENS[-1]


def row_groups(m: int, p: int, bits: int) -> List[Tuple[int, int]]:
    """The [start, stop) row ranges the batched wrapper launches one by
    one: all m rows when their partial sums fit in PARTIAL_BYTES, else
    equal groups of a multiple of ROW_TILE rows that do (at least
    ROW_TILE rows each; the last group may be shorter)."""
    row_bytes = 4 * (p // split_len(p)) * bits
    if m * row_bytes <= PARTIAL_BYTES:
        return [(0, m)]
    most = max(ROW_TILE, PARTIAL_BYTES // row_bytes // ROW_TILE * ROW_TILE)
    groups = -(-m // most)
    rows = -(-m // groups)
    rows = -(-rows // ROW_TILE) * ROW_TILE
    return [(a, min(a + rows, m)) for a in range(0, m, rows)]


def split_plan(p: int, m: Optional[int],
               bits: int) -> Tuple[int, List[Tuple[int, int]], tuple]:
    """(L, row groups, shape of the partial-sum scratch) of one call; m
    is None for the single-client entry point. L is `split_len(p)`
    whatever m and bits are; the scratch holds one group's sums."""
    chunk = split_len(p)
    if m is None:
        return chunk, [(0, 1)], (p // chunk, bits)
    groups = row_groups(m, p, bits)
    return chunk, groups, (p // chunk, groups[0][1] - groups[0][0], bits)


def launch_choice(m: int, p: int, bits: int) -> dict:
    """The C entry point's choice for an (m, p) input, launching nothing
    (builds the library): instance, rows (TM) and bits (TB) per block."""
    out = (ctypes.c_int * 3)()
    err = KERNEL.helper("lsh_plan", [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])(
        m, p, split_len(p), bits, ctypes.addressof(out))
    if err:
        raise ValueError(f"no launch for m={m}, p={p}, bits={bits}")
    return {"instance": INSTANCES[out[0]], "tm": out[1], "tb": out[2]}


def _check(x: torch.Tensor, ndim: int, bits: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {ndim}-D float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    p = x.shape[-1]
    if p % CHUNK or bits % 32 or bits <= 0 or x.numel() == 0:
        raise ValueError(f"need P % {CHUNK} == 0, bits % 32 == 0 and a "
                         f"non-empty x; got {tuple(x.shape)}, bits={bits}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel "
                         "reads it as float4)")


NEAR_TIES = "a code bit may differ where |sum| < 1e-3"


def _contract_args(point: dict):
    """Seeded CPU inputs of a contract point: x uniform in [-1, 1)."""
    g = torch.Generator().manual_seed(0)
    shape = (point["m"], point["p"]) if "m" in point else (point["p"],)
    x = torch.rand(shape, generator=g) * 2 - 1
    return (x, 7), {"bits": point["bits"], **(
        {"row_offset": point["row_offset"]} if "row_offset" in point else {})}


@kernel_contract(
    kernel=SINGLE_KERNEL, stands_for="lsh_single",
    twin="lsh_project_sums_ref", exactness="tolerance", rtol=1e-5,
    atol=4e-4, near_ties=NEAR_TIES,
    points=({"p": 4096, "bits": 256, "row_offset": 12_345},),
    make_args=_contract_args)
def lsh_project_sums(x: torch.Tensor, seed: int, *, bits: int = 256,
                     row_offset: int = 0) -> torch.Tensor:
    """(P,) f32, P % CHUNK == 0 -> (bits,) f32: one client's sums.
    `row_offset`: the global index of x[0] when x is a shard of a longer
    vector (its entry p is hashed as row row_offset + p of R, mod 2^32, as
    the JAX `rademacher_block(i0, ...)` does); 0 for a whole vector."""
    if x.device.type in PLAIN_DEVICES:
        return ref.lsh_project_sums_ref(x, seed, bits=bits,
                                        row_offset=row_offset)
    _check(x, 1, bits)
    p = x.shape[0]
    chunk, _, shape = split_plan(p, None, bits)
    partial = torch.empty(shape, dtype=torch.float32, device=x.device)
    out = torch.empty((bits,), dtype=torch.float32, device=x.device)
    SINGLE_KERNEL.launch(x.device, x.data_ptr(), p, chunk, bits,
                         int(seed) & MASK32, int(row_offset) & MASK32,
                         partial.data_ptr(), out.data_ptr())
    return out


@kernel_contract(
    kernel=KERNEL, stands_for="lsh_batched",
    twin="lsh_project_sums_batched_ref", exactness="tolerance", rtol=1e-5,
    atol=4e-4, near_ties=NEAR_TIES, helpers=("lsh_plan",),
    points=({"m": 4, "p": 4096, "bits": 256},), make_args=_contract_args)
def lsh_project_sums_batched(x: torch.Tensor, seed: int, *,
                             bits: int = 256) -> torch.Tensor:
    """(M, P) f32, P % CHUNK == 0 -> (M, bits) f32 projection sums."""
    if x.device.type in PLAIN_DEVICES:
        return ref.lsh_project_sums_batched_ref(x, seed, bits=bits)
    _check(x, 2, bits)
    m, p = x.shape
    chunk, groups, shape = split_plan(p, m, bits)
    partial = torch.empty(shape, dtype=torch.float32, device=x.device)
    out = torch.empty((m, bits), dtype=torch.float32, device=x.device)
    for a, b in groups:
        KERNEL.launch(x.device, x[a:b].data_ptr(), b - a, p, chunk, bits,
                      int(seed) & MASK32,
                      partial.data_ptr(), out[a:b].data_ptr())
    return out

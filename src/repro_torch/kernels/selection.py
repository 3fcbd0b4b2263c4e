"""Fused peer selection (WPFed Eq. 6-8 + top-N): wrappers of the one-shot,
the column-tiled and the grouped ANN CUDA kernels (the last under two
wrappers: per-bucket and per-row lists), and their launch plans.

`fused_select` and `fused_select_tiled` replace the TPU kernels
`repro/kernels/selection.py:fused_select` (`_select_kernel`) and
`fused_select_tiled` (`_select_tiled_kernel`) with one design in
`csrc/selection.cu` (two entry points, two launch counts): Hamming
distances on the tensor cores, exact integers from the binary product
popc(a & b) over packed codes (`mma.sync` m16n8k256 .b1 .and.popc;
d = popc(a) + popc(b) - 2 popc(a & b), where the TPU kernel takes the
+-1 Gram), weights gathered from the wrapper's exp table (so they equal
the plain versions' bit for bit), self at -inf, and a running top-N per
row in shared memory, filled in ascending column order with ascending-id
ties. A CTA owns a tile of rows (a multiple of 16) and walks column
tiles staged by cp.async; where M alone leaves SMs empty the columns
split over a thread-block cluster whose lists merge in split order.
Shared memory does not grow with M. `select_plan` (rows per CTA,
splits, column tile, threads, shared bytes) is a function of (M, W, N)
alone and changes no route: "auto" still switches at
`oneshot_smem_bytes(m) = 5m` (the one-shot knockout instance's row,
M = 46,489), which `backends.resolve_tiling` reads. The one-shot
wrapper takes any N <= M - 1 and any W; past `TILED_MAX_NEIGHBORS` or
`TILED_MAX_WORDS` the plan picks the knockout instance (one block per
row, XOR + popcount, N first-max passes). The bound is the 2*M*M*W*32
int8 operations of the TPU kernel's Gram and the per-pair epilogue; at
the main path's M=10 it is launch latency.

The TPU kernel `repro/kernels/selection.py:fused_select_ann`
(`_select_ann_kernel`), Eq. 6-8 on each row's K candidate ids from
`core/ann.py` with ties by candidate position, runs on one instance
with two entry forms. `fused_select_ann_grouped`, the route's
(`core/neighbor.py`), takes the per-bucket form
(`ann.bucket_candidates`): a client's candidates depend only on its
bucket, so up to `rows` clients of one slot form a tile of the exact
kernels' design in `csrc/selection.cu` (binary tensor cores,
lane-owned lists, cluster splits), whose columns are the slot's list
positions, codes and scores gathered by id through cp.async; 8-column
steps of sentinels alone are skipped. `ann_plan` (rows, tiles, splits)
is a function of (M, W, N, K, S) alone, so nothing is read back from
the device between the codes and the launch. Its bound is the
2*M*K*W*32 operations of the +-1 Gram on the rows' own lists, or the
S*K*4 bytes of the lists with the codes and the outputs.
`fused_select_ann` keeps the per-row contract for arbitrary (M, K)
candidate ids (repeats, the row itself anywhere, sentinels anywhere)
on the same entry point, one slot a row (`ann.per_row_slots`: the ids
are the lists, client i alone in slot i), where
`ann_plan(one_row_slots=True)` takes the entry point's one-row
instance: a warp per client, its lanes on the candidates (codes and
scores gathered by id, XOR + popcount, the next step's loads in
flight), the running top-N across the warp's registers. Its bound is
the M*K*4 bytes of the ids. The two wrappers launch through two
handles on the one symbol (`ANN_KERNEL`, `GROUPED_KERNEL`), so their
launches are counted apart.

Each wrapper takes its plain version (`ref.fused_select_ref`,
`ref.fused_select_tiled_ref`, `ref.ann_select_ref`,
`ref.ann_select_grouped_ref`) for CPU and `meta` tensors only
(`build.PLAIN_DEVICES`); for a CUDA tensor it launches its kernel or raises.
All four register with `analysis.registry.kernel_contract` (class
"exact": ids and weights equal to the plain version's on the same
device; the unfused Eq. 6-8 reference may differ where two weights are
within 1 ulp), the mma instances with their shared-memory mirrors
(`select_smem_bytes`, `ann_smem_bytes` in `csrc/selection.cu`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.registry import Estimator, kernel_contract
from repro_torch.kernels import ref
from repro_torch.kernels.build import (MAX_SHARED_BYTES, PLAIN_DEVICES,
                                       CudaKernel)

_EXACT_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
               + [ctypes.c_void_p] * 2)
KERNEL = CudaKernel("selection", "selection.cu", "fused_select", _EXACT_ARGS)
TILED_KERNEL = CudaKernel("selection_tiled", "selection.cu",
                          "fused_select_tiled", _EXACT_ARGS)
TILED_MAX_NEIGHBORS = 128   # running top-N slots per row in shared memory
TILED_MAX_WORDS = 32        # code words (1024 bits) per row

# select_plan (csrc/selection.cu: BK, T, MAX_WARPS, MAX_SPLITS): columns
# per staged tile; rows a warp holds (two m16 tiles); warps per CTA at
# most; the portable cluster size; the SMs of the H100; the fewest columns
# worth a split of their own
BLOCK_K = 64
ROWS_PER_WARP = 32
MAX_WARPS = 4
MAX_SPLITS = 8
FILL_SMS = 132
SPLIT_MIN_COLS = 128
KNOCKOUT_THREADS = 256


def oneshot_smem_bytes(m: int) -> int:
    """The one-shot route's shared-memory figure, the one
    `backends.resolve_tiling` compares with MAX_SHARED_BYTES: a weight
    and a taken flag per column, the knockout instance's row (the mma
    instance's shared memory does not grow with M)."""
    return 5 * m


def knockout_smem_bytes(m: int) -> int:
    """Dynamic shared memory of one knockout block (csrc/selection.cu):
    the row's M weights and a taken bit per column, below the route's
    `oneshot_smem_bytes(m)` with room for the block's 64 static bytes."""
    return 4 * (m + -(-m // 32))


def mma_words(w: int) -> int:
    """KW: the instance's code words, W rounded up to 8, 16 or 32 (one
    256-bit mma step per 8 words; zero words pad the codes and add
    nothing to any popcount)."""
    return 8 if w <= 8 else (16 if w <= 16 else 32)


def row_stride(nsel: int, grouped: bool = False) -> int:
    """Words between two rows' lists in the mma CTA. Exact instances: N
    rounded up to 4, then to an odd multiple of 4 (16-byte reads of 8
    rows hit 8 banks). Grouped: N made odd (the 32 lanes of a warp, each
    on its own row's list, hit 32 banks)."""
    return nsel | 1 if grouped else 4 * ((-(-nsel // 4)) | 1)


def select_smem_bytes(kw: int, rows: int, nsel: int,
                      grouped: bool = False) -> int:
    """Dynamic shared memory of one mma CTA (csrc/selection.cu: layout):
    the exp table (W*32 + 1 entries, to 16 bytes), two stages of BLOCK_K
    codes (KW + 4 words a column) and scores, the tile's column
    popcounts, and per row a list of `row_stride(N, grouped)` values and
    ids, an 8-column exchange tile and a threshold."""
    lut = (kw * 32 + 1 + 3) // 4 * 4
    stage = BLOCK_K * (kw + 4) + BLOCK_K
    return 4 * (lut + 2 * stage + BLOCK_K
                + 2 * rows * row_stride(nsel, grouped) + 9 * rows)


def select_plan(m: int, w: int, n: int) -> dict:
    """The exact kernels' launch for (M, W, N), N = min(n, M - 1).
    `instance`: "knockout" past TILED_MAX_NEIGHBORS or TILED_MAX_WORDS
    (the one-shot entry point only: one block of KNOCKOUT_THREADS per
    row), else "mma": `kw` words, `warps` per CTA (MAX_WARPS, or one per
    32 rows of M, halved while the row CTAs times the most splits would
    not reach half of FILL_SMS or the CTA's shared memory would pass
    MAX_SHARED_BYTES), `rows` per CTA (ROWS_PER_WARP * warps), and the
    columns cut into `splits` ranges of `split_len` (a multiple of 8; as
    many CTAs of a cluster per row tile as bring the grid to two CTAs an
    SM, up to MAX_SPLITS and at least SPLIT_MIN_COLS columns each),
    walked in tiles of `block_k`. `smem_bytes` is one CTA's dynamic
    shared memory, `ctas` the grid."""
    nsel = max(min(n, m - 1), 0)
    if nsel > TILED_MAX_NEIGHBORS or w > TILED_MAX_WORDS:
        return {"instance": "knockout", "kw": 0, "warps": 8, "rows": 1,
                "threads": KNOCKOUT_THREADS, "splits": 1, "split_len": m,
                "block_k": m, "smem_bytes": knockout_smem_bytes(m),
                "ctas": m}
    kw = mma_words(w)
    most_splits = max(1, min(MAX_SPLITS, -(-m // SPLIT_MIN_COLS)))
    warps = min(MAX_WARPS, -(-m // ROWS_PER_WARP))
    while warps > 1 and (
            -(-m // (ROWS_PER_WARP * warps)) * most_splits < FILL_SMS // 2
            or select_smem_bytes(kw, ROWS_PER_WARP * warps, nsel)
            > MAX_SHARED_BYTES):
        warps //= 2
    rows = ROWS_PER_WARP * warps
    row_ctas = -(-m // rows)
    splits = min(most_splits, -(-2 * FILL_SMS // row_ctas))
    split_len = -(-(-(-m // splits)) // 8) * 8
    return {"instance": "mma", "kw": kw, "warps": warps, "rows": rows,
            "threads": 32 * warps, "splits": splits, "split_len": split_len,
            "block_k": BLOCK_K, "smem_bytes": select_smem_bytes(kw, rows,
                                                                nsel),
            "ctas": row_ctas * splits}


def _launch(kernel: CudaKernel, codes: torch.Tensor, scores: torch.Tensor,
            lut: torch.Tensor, nsel: int, use_lsh: bool, use_rank: bool,
            tensors=(), sizes=None, plan_args=()):
    """Launch a selection kernel on CUDA tensors after the checks all
    four kernels share; its C arguments are codes, scores, lut, then the
    int32 `tensors` (candidates), `sizes` (default M, W), N, the two
    switches, `plan_args` and the outputs. (ids (M, nsel) int32, top_w
    (M, nsel) f32)."""
    m, w = codes.shape
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if codes.dtype != torch.int32 or scores.dtype != torch.float32:
        raise ValueError("codes must be int32 and scores float32, got "
                         f"{codes.dtype} / {scores.dtype}")
    if scores.shape != (m,) or scores.device != codes.device:
        raise ValueError("scores must be (M,) on the codes' device")
    if nsel <= 0:
        return (torch.zeros((m, 0), dtype=torch.int32, device=codes.device),
                torch.zeros((m, 0), dtype=torch.float32, device=codes.device))
    codes, scores = codes.contiguous(), scores.contiguous()
    tensors = [t.contiguous() for t in tensors]
    ids = torch.empty((m, nsel), dtype=torch.int32, device=codes.device)
    top_w = torch.empty((m, nsel), dtype=torch.float32, device=codes.device)
    kernel.launch(codes.device, codes.data_ptr(), scores.data_ptr(),
                  lut.data_ptr(), *(t.data_ptr() for t in tensors),
                  *(sizes or (m, w)), nsel, int(use_lsh), int(use_rank),
                  *plan_args, ids.data_ptr(), top_w.data_ptr())
    return ids, top_w


def _plan_args(plan: dict) -> tuple:
    return plan["kw"], plan["rows"], plan["splits"], plan["split_len"]


NEAR_TIES = ("the unfused Eq. 6-8 reference may order two weights within "
             "1 ulp differently")
GAMMA = 1.0          # the contract points' Eq. 8 gamma (the paper's)


def _contract_args(point: dict):
    """Seeded CPU inputs of a contract point: codes of every uint32
    pattern, Eq. 7 scores in [0, 1); `k` adds (M, K) candidate ids (a
    random order of the M + 1 ids, sentinel M included, per row)."""
    g = torch.Generator().manual_seed(0)
    m, bits = point["m"], point["bits"]
    codes = torch.randint(-2 ** 31, 2 ** 31, (m, bits // 32), generator=g,
                          dtype=torch.int64).to(torch.int32)
    scores = torch.rand((m,), generator=g)
    kw = {"bits": bits, "gamma": GAMMA, "num_neighbors": point["n"]}
    if "k" in point:
        cand = torch.rand((m, m + 1), generator=g).argsort(1)[:, :point["k"]]
        return (codes, scores, cand.to(torch.int32)), kw
    return (codes, scores), kw


def _twin(name: str):
    """The plain version `name` of ref on a wrapper's arguments: the exp
    table built on their device, as the wrapper builds it."""
    def call(args, kwargs):
        kw = dict(kwargs)
        bits, gamma = kw.pop("bits"), kw.pop("gamma")
        codes = args[0]
        lut = ref.selection_lut(codes.shape[1], bits, gamma,
                                device=codes.device)
        return getattr(ref, name)(*args, lut, **kw)
    return call


def _select_smem_args(point: dict):
    plan = select_plan(point["m"], point["bits"] // 32, point["n"])
    return [(plan["kw"], plan["rows"], min(point["n"], point["m"] - 1))]


SELECT_SMEM = Estimator("select_smem_bytes", select_smem_bytes,
                        _select_smem_args)
# exact-selection contract points (all on the mma instance)
SELECT_POINTS = ({"m": 64, "bits": 256, "n": 8},
                 {"m": 1024, "bits": 256, "n": 16},
                 {"m": 4096, "bits": 512, "n": 128},
                 {"m": 46_489, "bits": 1024, "n": 16})


@kernel_contract(
    kernel=KERNEL, stands_for="selection_oneshot", twin="fused_select_ref",
    twin_call=_twin("fused_select_ref"), exactness="exact",
    near_ties=NEAR_TIES, helpers=("select_smem_bytes",),
    estimators=(SELECT_SMEM,), points=SELECT_POINTS,
    make_args=_contract_args)
def fused_select(codes: torch.Tensor, scores: torch.Tensor, *, bits: int,
                 gamma: float, num_neighbors: int, use_lsh: bool = True,
                 use_rank: bool = True):
    """codes (M, W) int32 (uint32 patterns), scores (M,) f32 ->
    (ids (M, N) int32, top_w (M, N) f32), N = min(num_neighbors, M-1).
    Bit-equal to `ref.fused_select_ref` on every rank, including ranks
    whose weight is -inf (the row itself, -inf score columns such as the
    service's departed clients): those hold their ids in ascending
    order, as `lax.top_k` gives them."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type in PLAIN_DEVICES:
        return ref.fused_select_ref(codes, scores, lut,
                                    num_neighbors=num_neighbors,
                                    use_lsh=use_lsh, use_rank=use_rank)
    if oneshot_smem_bytes(m) > MAX_SHARED_BYTES:
        raise ValueError(f"M={m} exceeds the one-shot kernel's shared "
                         "memory; select with tiling=\"tiled\" or \"auto\" "
                         "(the column-tiled kernel)")
    return _launch(KERNEL, codes, scores, lut, min(num_neighbors, m - 1),
                   use_lsh, use_rank,
                   plan_args=_plan_args(select_plan(m, w, num_neighbors)))


@kernel_contract(
    kernel=TILED_KERNEL, stands_for="selection_tiled",
    twin="fused_select_tiled_ref", twin_call=_twin("fused_select_tiled_ref"),
    exactness="exact", near_ties=NEAR_TIES, helpers=("select_smem_bytes",),
    estimators=(SELECT_SMEM,),
    points=({"m": 200, "bits": 256, "n": 16},) + SELECT_POINTS[1:]
    + ({"m": 65_536, "bits": 256, "n": 16},),
    make_args=_contract_args)
def fused_select_tiled(codes: torch.Tensor, scores: torch.Tensor, *,
                       bits: int, gamma: float, num_neighbors: int,
                       use_lsh: bool = True, use_rank: bool = True):
    """`fused_select`'s contract through the column-tiled kernel, for any
    M: codes (M, W) int32, scores (M,) f32 -> (ids (M, N) int32,
    top_w (M, N) f32), N = min(num_neighbors, M-1) <= TILED_MAX_NEIGHBORS.
    Bit-equal to `fused_select` and to the plain versions, -inf ranks
    included."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type in PLAIN_DEVICES:
        return ref.fused_select_tiled_ref(codes, scores, lut,
                                          num_neighbors=num_neighbors,
                                          use_lsh=use_lsh, use_rank=use_rank)
    nsel = min(num_neighbors, m - 1)
    if nsel > TILED_MAX_NEIGHBORS or w > TILED_MAX_WORDS:
        raise ValueError(f"N={nsel}, W={w}: the tiled selection kernel takes "
                         f"N <= {TILED_MAX_NEIGHBORS} and codes of at most "
                         f"{TILED_MAX_WORDS * 32} bits")
    return _launch(TILED_KERNEL, codes, scores, lut, nsel, use_lsh, use_rank,
                   plan_args=_plan_args(select_plan(m, w, num_neighbors)))


_GROUPED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + \
    [ctypes.c_void_p] * 2
GROUPED_KERNEL = CudaKernel("selection_ann_grouped", "selection.cu",
                            "fused_select_ann_grouped", _GROUPED_ARGS)
# the per-row function's handle on the same entry point: its launches are
# counted apart from the route's
ANN_KERNEL = CudaKernel("selection_ann", "selection.cu",
                        "fused_select_ann_grouped", _GROUPED_ARGS)
# the one-row instance (`ann_plan(one_row_slots=True)`): clients a CTA,
# one a warp (csrc/selection.cu takes at most 8)
ONE_SLOT_ROWS = 4
INT32_MAX = 2 ** 31 - 1


def ann_smem_bytes(kw: int, rows: int, nsel: int) -> int:
    """Dynamic shared memory of one grouped CTA (csrc/selection.cu:
    layout): `select_smem_bytes` with the grouped list stride, and a
    ring of three BLOCK_K-id tiles."""
    return select_smem_bytes(kw, rows, nsel, grouped=True) + 4 * 3 * BLOCK_K


def ann_plan(m: int, w: int, n: int, k: int, n_slots: int, *,
             one_row_slots: bool = False) -> dict:
    """The grouped ANN kernel's launch for M clients, W words, N =
    min(n, M - 1) partners, K candidate positions and S = `n_slots` list
    rows (`bucket_candidates`), from these shapes alone: `rows` per tile
    (ROWS_PER_WARP * `warps`: MAX_WARPS, halved while the CTA's shared
    memory would pass MAX_SHARED_BYTES; warps past a small bucket's
    clients skip the products and still stage columns, which measured
    faster on the H100 at M = 10 and 4,096 than CTAs sized to the mean
    bucket); `tiles` = ceil(M / rows) + S, a bound on sum over slots of
    ceil(clients / rows) for any bucket layout (tiles past a slot's
    clients exit); the K positions cut into `splits` ranges of
    `split_len` (a multiple of 8; as many CTAs of a cluster per tile as
    bring the tiles the buckets are expected to fill, max(ceil(M / rows),
    min(S, M)), to two CTAs an SM, up to MAX_SPLITS and at least
    SPLIT_MIN_COLS positions each). `ctas` is the grid, `smem_bytes` one
    CTA's dynamic shared memory.

    `one_row_slots` (only the per-row function's `core.ann.per_row_slots`
    passes it: S = M whatever `n_slots` says, one client a slot, so the
    plan is a function of (M, W, N, K)) takes the one-row instance
    (`instance` "warp"): a warp per client, `rows` = `warps` =
    ONE_SLOT_ROWS clients a CTA, `tiles` = ceil(M / rows) CTAs, no split,
    `block_k` the positions a warp weighs a step (two a lane up to 16
    words, else one), no dynamic shared memory. Timed on the H100
    (`scripts/torch_ann_ab.py --per-row`, M = 65,536, K = 2,336): the
    tile instance on this form took 4.03 / 6.09 / 8.77 ms at 32 / 64 /
    128 rows a tile, the per-row kernel it replaced 1.44-1.45, the
    one-row instance 0.780 / 0.781-0.796 / 0.797-0.799 at 2 / 4 / 8
    clients a CTA (4 is within 3 % of the best at every per-row shape of
    `chip_smoke.py`)."""
    nsel = max(min(n, m - 1), 0)
    kw = mma_words(w)
    if one_row_slots:
        tiles = -(-m // ONE_SLOT_ROWS)
        return {"instance": "warp", "kw": kw, "warps": ONE_SLOT_ROWS,
                "rows": ONE_SLOT_ROWS, "threads": 32 * ONE_SLOT_ROWS,
                "tiles": tiles, "splits": 1, "split_len": -(-k // 8) * 8,
                "block_k": 64 if kw <= 16 else 32, "smem_bytes": 0,
                "ctas": tiles}
    warps = MAX_WARPS
    while warps > 1 and ann_smem_bytes(kw, ROWS_PER_WARP * warps,
                                       nsel) > MAX_SHARED_BYTES:
        warps //= 2
    rows = ROWS_PER_WARP * warps
    tiles = -(-m // rows) + n_slots
    filled = max(-(-m // rows), min(n_slots, m))
    most_splits = max(1, min(MAX_SPLITS, -(-k // SPLIT_MIN_COLS)))
    splits = min(most_splits, -(-2 * FILL_SMS // filled))
    split_len = -(-(-(-k // splits)) // 8) * 8
    return {"kw": kw, "warps": warps, "rows": rows, "threads": 32 * warps,
            "tiles": tiles, "splits": splits, "split_len": split_len,
            "block_k": BLOCK_K, "smem_bytes": ann_smem_bytes(kw, rows, nsel),
            "ctas": tiles * splits}


def _launch_grouped(kernel: CudaKernel, codes: torch.Tensor,
                    scores: torch.Tensor, lut: torch.Tensor, cand, nsel: int,
                    use_lsh: bool, use_rank: bool, plan: dict):
    """Launch the grouped instance (`kernel`, a handle on
    `fused_select_ann_grouped`) on the per-bucket form `cand` after the
    checks both ANN wrappers share."""
    m, w = codes.shape
    s, k = cand.lists.shape if cand.lists.ndim == 2 else (0, 0)
    for name, t, shape in (("lists", cand.lists, (s, k)),
                           ("order", cand.order, (m,)),
                           ("starts", cand.starts, (s + 1,))):
        if t.dtype != torch.int32 or t.shape != shape or \
                t.device != codes.device:
            raise ValueError(f"cand.{name} must be {shape} int32 on the "
                             f"codes' device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if nsel > TILED_MAX_NEIGHBORS or w > TILED_MAX_WORDS or nsel > k or \
            s < 1:
        raise ValueError(f"N={nsel}, W={w}, K={k}, S={s}: the grouped ANN "
                         f"kernel takes N <= {TILED_MAX_NEIGHBORS}, N <= K "
                         f"and codes of at most {TILED_MAX_WORDS * 32} bits")
    # the kernel counts positions and CTAs in int32: a position runs up to
    # K + 2 * BLOCK_K (the id tiles read ahead), the grid to tiles * splits
    if k > INT32_MAX - 2 * BLOCK_K or plan["ctas"] > INT32_MAX:
        raise ValueError(f"K={k}, {plan['ctas']} CTAs: the grouped ANN "
                         f"kernel takes K <= {INT32_MAX - 2 * BLOCK_K} and "
                         f"a grid of at most {INT32_MAX} CTAs")
    return _launch(kernel, codes, scores, lut, nsel, use_lsh, use_rank,
                   (cand.lists, cand.order, cand.starts), (m, w, k, s),
                   _plan_args(plan) + (plan["tiles"],
                                       int(plan.get("instance") == "warp")))


@kernel_contract(
    kernel=ANN_KERNEL, stands_for="selection_ann", twin="ann_select_ref",
    twin_call=_twin("ann_select_ref"), exactness="exact",
    points=({"m": 64, "bits": 256, "n": 8, "k": 32},),
    make_args=_contract_args)
def fused_select_ann(codes: torch.Tensor, scores: torch.Tensor,
                     cand_ids: torch.Tensor, *, bits: int, gamma: float,
                     num_neighbors: int, use_lsh: bool = True,
                     use_rank: bool = True):
    """Eq. 6-8 + top-N on candidate sets: codes (M, W) int32, scores (M,)
    f32, cand_ids (M, K) int32 ids in [0, M] (M marks an invalid slot) ->
    (ids (M, N) int32, top_w (M, N) f32), N = min(num_neighbors, M-1) <=
    TILED_MAX_NEIGHBORS and <= K. Slots with no finite weight get id 0
    and weight -inf. Bit-equal to `ref.ann_select_ref`. On the card the
    grouped entry point runs it, one slot a row (`core.ann.per_row_slots`)
    on its one-row instance (`ann_plan(one_row_slots=True)`)."""
    from repro_torch.core.ann import per_row_slots
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type in PLAIN_DEVICES:
        return ref.ann_select_ref(codes, scores, cand_ids, lut,
                                  num_neighbors=num_neighbors,
                                  use_lsh=use_lsh, use_rank=use_rank)
    nsel = min(num_neighbors, m - 1)
    k = cand_ids.shape[1] if cand_ids.ndim == 2 else 0
    if cand_ids.dtype != torch.int32 or cand_ids.shape != (m, k) or \
            cand_ids.device != codes.device:
        raise ValueError("cand_ids must be (M, K) int32 on the codes' "
                         f"device, got {cand_ids.dtype} "
                         f"{tuple(cand_ids.shape)}")
    plan = ann_plan(m, w, num_neighbors, k, m, one_row_slots=True)
    return _launch_grouped(ANN_KERNEL, codes, scores, lut,
                           per_row_slots(cand_ids, m), nsel, use_lsh,
                           use_rank, plan)


def _grouped_args(point: dict):
    """`_contract_args` with the per-bucket candidates of the codes
    (`core.ann.bucket_candidates`, as the ANN route builds them)."""
    from repro_torch.core import ann
    (codes, scores), kw = _contract_args(point)
    cand = ann.bucket_candidates(
        codes, scores, seed=0, prefix_bits=point["prefix_bits"],
        probes=point["probes"], num_neighbors=min(point["n"],
                                                  point["m"] - 1))
    return (codes, scores, cand), kw


def _ann_smem_args(point: dict):
    nsel = min(point["n"], point["m"] - 1)
    plan = ann_plan(point["m"], point["bits"] // 32, point["n"], 1, 1)
    return [(plan["kw"], plan["rows"], nsel)]


@kernel_contract(
    kernel=GROUPED_KERNEL, stands_for="selection_ann",
    twin="ann_select_grouped_ref", twin_call=_twin("ann_select_grouped_ref"),
    exactness="exact", helpers=("ann_smem_bytes",),
    estimators=(Estimator("ann_smem_bytes", ann_smem_bytes,
                          _ann_smem_args),),
    points=({"m": 64, "bits": 256, "n": 8, "prefix_bits": 2, "probes": 1},
            {"m": 4096, "bits": 256, "n": 16, "prefix_bits": 10,
             "probes": 8},
            {"m": 65_536, "bits": 1024, "n": 128, "prefix_bits": 10,
             "probes": 8}),
    make_args=_grouped_args)
def fused_select_ann_grouped(codes: torch.Tensor, scores: torch.Tensor, cand,
                             *, bits: int, gamma: float, num_neighbors: int,
                             use_lsh: bool = True, use_rank: bool = True):
    """`fused_select_ann`'s contract on per-bucket candidates
    (`core.ann.bucket_candidates`): codes (M, W) int32, scores (M,) f32
    -> (ids (M, N) int32, top_w (M, N) f32), N = min(num_neighbors, M-1)
    <= TILED_MAX_NEIGHBORS and <= K. Each tile of `ann_plan` runs one
    slot's rows against its list on the binary tensor cores. Bit-equal
    to `ref.ann_select_grouped_ref`, and so to `fused_select_ann` on
    `ann_candidates` of the same codes; a rank whose weight is not finite
    (too few finite candidates, -inf score columns) holds id 0."""
    m, w = codes.shape
    lut = ref.selection_lut(w, bits, gamma, device=codes.device)
    if codes.device.type in PLAIN_DEVICES:
        return ref.ann_select_grouped_ref(codes, scores, cand, lut,
                                          num_neighbors=num_neighbors,
                                          use_lsh=use_lsh, use_rank=use_rank)
    s, k = cand.lists.shape if cand.lists.ndim == 2 else (0, 0)
    plan = ann_plan(m, w, num_neighbors, k, s)
    return _launch_grouped(GROUPED_KERNEL, codes, scores, lut, cand,
                           min(num_neighbors, m - 1), use_lsh, use_rank,
                           plan)

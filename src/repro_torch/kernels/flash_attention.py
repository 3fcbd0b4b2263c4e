"""Flash-attention forward (online softmax): wrapper of the CUDA kernel.

Replaces the TPU kernel `repro/kernels/flash_attention.py:flash_attention`
(`_flash_kernel`). The kernel (`csrc/flash_attention.cu`) runs persistent
blocks of two warpgroups (one for f32 at dh > 128) over work items of
(batch, KV head, 128 packed rows; 64 for f32 at dh > 128): the G = H / KV
query heads of a KV head are packed into the rows position-major
(packed row r is position r // G of head kvh * G + r % G), so K/V tiles
are read once per item for all G heads and a short sequence fills the
rows (at S 32 with 4 heads over 1 KV head, one item of 128 live rows).
The grid is what fits on the card's SMs, each block walking its items
longest first; its K/V tiles stream through a ring in shared memory that
every thread fills by cp.async and that mbarriers hand over (no
`__syncthreads` in the loop, so the two warpgroups drift apart and one's
softmax runs under the other's products), the next item's Q is loaded
while an item computes, and O leaves through shared memory by 16-byte
stores. Products run on Hopper's tensor cores (`wgmma`): f32 inputs
through 3xTF32 (hi*hi + hi*lo + lo*hi, the f32 accuracy of the plain
version), bf16 inputs through bf16 products with P split into two bf16
halves; the scores, P and the running max and sum stay in registers. It
computes exactly `ref.flash_attention_ref`: f32 arithmetic on f32 or bf16
inputs, scale dh**-0.5 when 0 is passed, the causal mask aligned top-left
with -1e30 for a masked score, out = acc / max(l, 1e-30) in the input
dtype. It takes any Sq and Sk and dh <= 256; rows that are not 16-byte
aligned are staged element by element inside the kernel. Its bound on
the H100 is the larger of q, k, v and out moved once (3.35 TB/s) and
4 * N * pairs * dh operations on the tensor cores: f32 at 495 / 3 TFLOP/s
(three TF32 products each), bf16 at 989 TFLOP/s. Every configuration
has two instances: one for calls whose q, k and v rows are all 16-byte
aligned (the loops hold no element-by-element staging), one that stages
unaligned rows through registers.

`flash_plan` gives the launch the kernel makes for a call (its
configuration, G, rows per item, items, keys per stage, stages, shared
memory, blocks per SM and grid); the kernel's source exports its C mirror
`flash_plan_field`, which the analysis gate holds equal on the card.

`flash_attention` takes the TPU kernel's (N, S, dh) layout;
`gqa_attention` takes the model's (B, S, H, dh) queries and (B, S, KV, dh)
keys and values and reads KV head h // (H // KV) for query head h through
strides, without materialising the repeat. Both take the plain version
for CPU and `meta` tensors only (`build.PLAIN_DEVICES`); for CUDA tensors
they launch the kernel or raise.
The kernel has no backward (the JAX package has none either): on the
card they raise when grad mode is on and q, k or v requires grad, rather
than return an output without a gradient.
`gqa_attention`, the wrapper that launches, registers with
`analysis.registry.kernel_contract` (class "tolerance": max abs error
2e-5 in f32 on unit-normal inputs).

The wrapper reaches the kernel through the custom op
`torch.ops.repro_torch.gqa_attention`, so that the federation's client
axis can run under `torch.func.vmap` (the JAX counterpart is Pallas's
own batching rule under `jax.vmap`): a ctypes launch reads
`data_ptr()`, which a vmapped tensor does not have. The op's vmap rule
folds the vmapped dimension into B, (V, B, S, H, dh) -> (V * B, S, H,
dh), calls the op once on the folded tensors and splits the result
back; nested vmaps fold level by level into one launch. Its fake
implementation gives the output's shape and dtype. The op runs the
plain version on the CPU and launches the kernel on the card; `meta`
tensors, and CPU tensors that need a gradient, take the plain version
in the wrapper itself (it is differentiable and counts its FLOPs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.registry import Estimator, kernel_contract
from repro_torch.kernels import ref
from repro_torch.kernels.build import PLAIN_DEVICES, CudaKernel

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int])
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
H100_SMS = 132
# The kernel's configurations, as `csrc/flash_attention.cu:with_cfg`
# picks them by dtype, head dim and, at dh <= 64, Sk <= 32 (the short
# ones): name -> (head dim, warpgroups, keys per stage, stages, Q buffers
# per warpgroup, resident blocks per SM).
CONFIGS = {
    "f32-d64-short": (64, 2, 32, 2, 2, 1),
    "f32-d64": (64, 2, 64, 2, 2, 1),
    "f32-d128": (128, 2, 32, 2, 1, 1),
    "f32-d256": (256, 1, 16, 1, 1, 1),
    "bf16-d64-short": (64, 2, 32, 4, 2, 2),
    "bf16-d64": (64, 2, 64, 4, 2, 1),
    "bf16-d128": (128, 2, 64, 4, 2, 1),
    "bf16-d256": (256, 2, 32, 3, 1, 1),
}
# `flash_plan_field`'s fields, in its order
PLAN_FIELDS = ("smem_bytes", "items", "grid", "bk", "stages",
               "rows_per_item", "blocks_per_sm", "group", "q_buffers",
               "head_dim", "warpgroups", "paired")


def flash_config(dtype: torch.dtype, dh: int, sk: int) -> str:
    """The name of the configuration the kernel takes for (dtype, dh,
    Sk)."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    if dh <= 64:
        return f"{kind}-d64-short" if sk <= 32 else f"{kind}-d64"
    return f"{kind}-d128" if dh <= 128 else f"{kind}-d256"


def _tile_bytes(rows: int, chunks: int, sbo: int) -> int:
    """A wgmma operand tile of `rows` x `chunks` 16-byte chunks (the
    kernel's `Tile`): chunks * ((rows / 8) * SBO + 16) bytes."""
    return chunks * ((rows // 8) * sbo + 16)


def config_smem_bytes(name: str) -> int:
    """Dynamic shared memory of one block of a configuration (the
    kernel's `Cfg::SMEM`): mbarriers, Q buffers and the ring's stages."""
    dh, nwg, bk, stages, qbuf, _ = CONFIGS[name]
    f32 = name.startswith("f32")
    e = 4 if f32 else 8
    ck = dh // e
    qt = _tile_bytes(64, ck, 128) * (2 if f32 and dh > 128 else 1)
    kt = _tile_bytes(bk, ck, 128)
    v = _tile_bytes(dh, bk // e, 144) if f32 else kt
    stage = (2 if f32 else 1) * (kt + v)
    bars = 3 * stages + nwg * qbuf  # full, ready, empty; Q buffers
    return -(-8 * bars // 128) * 128 + qbuf * nwg * qt + stages * stage


def flash_plan(b: int, sq: int, sk: int, h: int, kvh: int, dh: int,
               dtype: torch.dtype, causal: bool, sms: int = H100_SMS) -> dict:
    """The launch the kernel makes for q (b, sq, h, dh) and k, v (b, sk,
    kvh, dh) on a card of `sms` SMs: its configuration, G = h / kvh query
    heads packed per item, packed rows per item, items (b * kvh *
    ceil(sq * G / rows)), keys per stage, stages, Q buffers per
    warpgroup, shared memory per block, resident blocks per SM, whether
    blocks take pairs of items (causal, more items than resident blocks)
    and the grid: min(ceil(items / 2) if paired else items, blocks per SM
    * sms)."""
    if kvh < 1 or h % kvh:
        raise ValueError(f"H={h} is not a multiple of KV={kvh}")
    name = flash_config(dtype, dh, sk)
    cdh, nwg, bk, stages, qbuf, minb = CONFIGS[name]
    g = h // kvh
    rows = 64 * nwg
    items = b * kvh * (-(-sq * g // rows))
    paired = bool(causal) and items > minb * sms
    return {"config": name, "group": g, "rows_per_item": rows,
            "items": items, "bk": bk, "stages": stages, "q_buffers": qbuf,
            "smem_bytes": config_smem_bytes(name), "blocks_per_sm": minb,
            "grid": min(-(-items // 2) if paired else items, minb * sms),
            "paired": paired, "head_dim": cdh, "warpgroups": nwg}


def flash_plan_field(bf16: int, b: int, sq: int, sk: int, h: int, kvh: int,
                     dh: int, causal: int, sms: int, field: int) -> int:
    """One field of `flash_plan` as the kernel's C mirror
    `flash_plan_field` takes and returns it (-1 for a field past
    `PLAN_FIELDS`)."""
    plan = flash_plan(b, sq, sk, h, kvh, dh,
                      torch.bfloat16 if bf16 else torch.float32,
                      bool(causal), sms)
    return int(plan[PLAN_FIELDS[field]]) if field < len(PLAN_FIELDS) else -1


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the attention must score: all of them, or with
    the top-left causal mask sum_i min(i + 1, Sk) (S(S+1)/2 at Sq = Sk)."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + (sq - full) * sk


def attention_flops(b: int, h: int, sq: int, sk: int, dh: int,
                    causal: bool) -> int:
    """The kernel's work: two products of 2 * dh FLOPs for every scored
    (query, key) pair of every head, 4 * B * H * pairs * dh (its bound's
    operations in chip_smoke.py)."""
    return 4 * b * h * attention_pairs(sq, sk, causal) * dh


def plain_gqa_attention(q, k, v, causal, scale):
    """`gqa_attention` through the plain version, as the JAX wrapper maps
    it onto the (N, S, dh) layout: KV heads repeated to H, heads moved
    next to the batch."""
    b, sq, h, dh = q.shape
    g = h // k.shape[2]
    qk = q.movedim(2, 1).reshape(b * h, sq, dh)
    kx = k.movedim(2, 1).repeat_interleave(g, dim=1).reshape(b * h, -1, dh)
    vx = v.movedim(2, 1).repeat_interleave(g, dim=1).reshape(b * h, -1, dh)
    o = ref.flash_attention_ref(qk, kx, vx, causal=causal, scale=scale)
    return o.reshape(b, h, sq, dh).movedim(1, 2)


def _contract_args(point: dict):
    """Seeded CPU unit-normal q (B, S, H, dh), k and v (B, S, KV, dh)."""
    g = torch.Generator().manual_seed(0)
    b, s, dh = point["b"], point["s"], point["dh"]
    q = torch.randn((b, s, point["h"], dh), generator=g)
    k = torch.randn((b, s, point["kv"], dh), generator=g)
    v = torch.randn((b, s, point["kv"], dh), generator=g)
    return (q, k, v), {"causal": point["causal"]}


def _needs_grad(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors q (B, Sq, H, dh), k, v
    (B, Sk, KV, dh)."""
    b, sq, h, dh = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype} / {k.dtype} / {v.dtype}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    scale = scale or dh ** -0.5
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), int(q.dtype == torch.bfloat16), b, h, kvh,
                  sq, sk, dh, *q.stride()[:3], *k.stride()[:3],
                  *v.stride()[:3], *out.stride()[:3], float(scale),
                  int(causal))
    return out


@torch.library.custom_op("repro_torch::gqa_attention", mutates_args=())
def gqa_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, scale: float) -> torch.Tensor:
    """The op behind `gqa_attention`: the plain version on the CPU, one
    kernel launch on the card."""
    if q.device.type in PLAIN_DEVICES:
        return plain_gqa_attention(q, k, v, causal, scale)
    return _launch(q, k, v, causal, scale)


@gqa_attention_op.register_fake
def _gqa_attention_fake(q, k, v, causal, scale):
    return q.new_empty(q.shape)


def _fold(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """`t` with its vmapped dimension `dim` (None: not vmapped, so
    broadcast to `size`) merged into the batch: (V, B, ...) -> (V * B,
    ...)."""
    t = t.expand(size, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(size * t.shape[1], *t.shape[2:])


@gqa_attention_op.register_vmap
def _gqa_attention_vmap(info, in_dims, q, k, v, causal, scale):
    """One launch for every vmapped call: fold, call, split."""
    n = info.batch_size
    out = gqa_attention_op(*(_fold(t, d, n) for t, d in zip((q, k, v),
                                                            in_dims[:3])),
                           causal, scale)
    return out.reshape(n, -1, *out.shape[1:]), 0


def _plan_args(point: dict):
    """`flash_plan_field` arguments at a point: every field, both dtypes,
    on the H100's SMs."""
    return [(bf16, point["b"], point["s"], point["s"], point["h"],
             point["kv"], point["dh"], int(point["causal"]), H100_SMS, f)
            for bf16 in (0, 1) for f in range(len(PLAN_FIELDS))]


@kernel_contract(
    kernel=KERNEL, stands_for="flash_attention", twin="flash_attention_ref",
    twin_call=lambda args, kwargs: plain_gqa_attention(
        *args, kwargs["causal"], 0.0),
    exactness="tolerance", atol=2e-5, helpers=("flash_plan_field",),
    estimators=(Estimator("flash_plan_field", flash_plan_field,
                          _plan_args),),
    # the contract launch (points[0]), then plan shapes: the federation's
    # neighbour web, Minitron-4B's and grok-1's prefill, whisper's
    # encoder, a ragged packed GQA shape, dh 256
    points=({"b": 1, "s": 192, "h": 4, "kv": 2, "dh": 64, "causal": True},
            {"b": 16_384, "s": 32, "h": 4, "kv": 1, "dh": 64,
             "causal": True},
            {"b": 4, "s": 2048, "h": 24, "kv": 8, "dh": 128,
             "causal": True},
            {"b": 4, "s": 2048, "h": 48, "kv": 8, "dh": 128,
             "causal": True},
            {"b": 4, "s": 1500, "h": 12, "kv": 12, "dh": 64,
             "causal": False},
            {"b": 2, "s": 41, "h": 6, "kv": 2, "dh": 100, "causal": True},
            {"b": 2, "s": 512, "h": 2, "kv": 2, "dh": 256,
             "causal": True}),
    make_args=_contract_args)
def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, dh), k/v (B, Sk, KV, dh), H a multiple of KV ->
    (B, Sq, H, dh) in q's dtype. Runs under `torch.func.vmap` (one launch
    per call, through the op's vmap rule)."""
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must be on one device, got "
                         f"{q.device} / {k.device} / {v.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"q must be (B, Sq, H, dh) and k, v (B, Sk, KV, dh) "
                         f"with H a multiple of KV, got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    dev = q.device.type
    if dev == "meta" or (dev in PLAIN_DEVICES and _needs_grad(q, k, v)):
        return plain_gqa_attention(q, k, v, causal, scale)
    if dev not in PLAIN_DEVICES and dev != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if dev == "cuda" and _needs_grad(q, k, v):
        raise RuntimeError(
            "the flash-attention kernel has no backward, so its output "
            "would carry no gradient to q, k or v; train through the "
            "differentiable route: transformer.forward(..., "
            "differentiable=True), as train.steps.lm_loss does")
    return gqa_attention_op(q, k, v, bool(causal), float(scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = 0.0) -> torch.Tensor:
    """q (N, Sq, dh), k/v (N, Sk, dh) -> (N, Sq, dh) in q's dtype: the
    TPU kernel's layout, one head per row of N."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"q must be (N, Sq, dh) and k, v (N, Sk, dh), got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if q.device.type in PLAIN_DEVICES and k.device == q.device \
            and v.device == q.device:
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return gqa_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=causal, scale=scale)[:, :, 0]

"""Flash-attention forward (online softmax): wrapper of the CUDA kernel.

Replaces the TPU kernel `repro/kernels/flash_attention.py:flash_attention`
(`_flash_kernel`). The kernel (`csrc/flash_attention.cu`) runs one block
of two warpgroups per (head, 128 query rows; one and 64 rows for f32 at
dh > 128) on Hopper's tensor cores (`wgmma`): f32 inputs through 3xTF32
(hi*hi + hi*lo + lo*hi, the f32 accuracy of the plain version), bf16
inputs through bf16 products with P split into two bf16 halves. K/V tiles stream through a cp.async ring in
shared memory, and the scores, P and the running max and sum stay in
registers, so only q, k, v and the output touch device memory. It
computes exactly `ref.flash_attention_ref`: f32 arithmetic on f32 or bf16
inputs, scale dh**-0.5 when 0 is passed, the causal mask aligned top-left
with -1e30 for a masked score, out = acc / max(l, 1e-30) in the input
dtype. It takes any Sq and Sk and dh <= 256; rows that are not 16-byte
aligned are staged element by element inside the kernel. Its bound on
the H100 is the 4 * N * pairs * dh operations on the tensor cores: f32 at
495 / 3 TFLOP/s (three TF32 products each), bf16 at 989 TFLOP/s.

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

from repro_torch.analysis.registry import kernel_contract
from repro_torch.kernels import ref
from repro_torch.kernels.build import PLAIN_DEVICES, CudaKernel

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int])
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)


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


@kernel_contract(
    kernel=KERNEL, stands_for="flash_attention", twin="flash_attention_ref",
    twin_call=lambda args, kwargs: plain_gqa_attention(
        *args, kwargs["causal"], 0.0),
    exactness="tolerance", atol=2e-5,
    points=({"b": 1, "s": 192, "h": 4, "kv": 2, "dh": 64,
             "causal": True},),
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

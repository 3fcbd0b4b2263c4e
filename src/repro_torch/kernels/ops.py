"""Packing, hashing and flattening helpers around the LSH kernel.

Counterpart of `repro/kernels/ops.py`. Packed LSH codes live as
`torch.int32` tensors holding the uint32 bit pattern of the JAX
package's codes (`.numpy().view(np.uint32)` converts at the boundary).
torch has no complete uint32 arithmetic, so the uint32 hash is emulated
in int64 with a mask after every multiply and logical shifts on
non-negative values.
"""
from __future__ import annotations

from typing import Dict

import torch

CHUNK = 2048       # the flattened parameter vector is padded to a multiple
MASK32 = 0xFFFFFFFF
K1 = 2654435761    # Knuth multiplicative hash, as repro.kernels.lsh_projection
K2 = 40503
K3 = 2246822519


def mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 `a` in [0, 2^32) and a constant k.

    Split into 16-bit halves of k so no product leaves int64."""
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def rademacher_block(i0: int, chunk: int, bits: int, seed: int,
                     device=None) -> torch.Tensor:
    """The deterministic +-1 block R[i0:i0+chunk, :bits] (f32).

    Bit-exact with `repro.kernels.lsh_projection.rademacher_block`,
    whose uint32 expression is
    h = (i*K1) ^ ((j*K2) + seed*K3); h ^= h>>15; h *= K3; h ^= h>>13;
    R = 1 - 2*((h>>9)&1), with i the global parameter index and j the
    bit. The CUDA kernel computes the same hash in registers."""
    i = (torch.arange(chunk, dtype=torch.int64, device=device) + i0) & MASK32
    j = torch.arange(bits, dtype=torch.int64, device=device)
    cj = (j * K2 + ((int(seed) & MASK32) * K3 & MASK32)) & MASK32
    h = mul32(i, K1)[:, None] ^ cj[None, :]
    h = h ^ (h >> 15)
    h = mul32(h, K3)
    h = h ^ (h >> 13)
    bit = (h >> 9) & 1
    return 1.0 - 2.0 * bit.to(torch.float32)


def leaf_key(name: str):
    """Sort key that puts dotted parameter names in `jax.tree.leaves`
    order: dict keys sorted as strings, list entries by index."""
    return tuple(int(s) if s.isdigit() else s for s in name.split("."))


def flatten_params(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One client's {name: tensor} params -> (P,) f32, P padded to a
    CHUNK multiple, in `flatten_params_batched`'s leaf order, so it
    equals `repro.kernels.ops.flatten_params` of the same weights."""
    names = sorted(params, key=leaf_key)
    flat = torch.cat([params[k].reshape(-1).to(torch.float32)
                      for k in names])
    return torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % CHUNK))


def flatten_params_batched(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stacked {name: (M, ...)} params -> (M, P) f32, P padded to a CHUNK
    multiple, leaves in `jax.tree.leaves` order and JAX layouts, so row i
    equals `repro.kernels.ops.flatten_params_batched` of the same
    weights."""
    names = sorted(params, key=leaf_key)
    m = params[names[0]].shape[0]
    flat = torch.cat([params[k].reshape(m, -1).to(torch.float32)
                      for k in names], dim=1)
    pad = (-flat.shape[1]) % CHUNK
    return torch.nn.functional.pad(flat, (0, pad))


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def pack_bits(sums: torch.Tensor) -> torch.Tensor:
    """Sign bits of projection sums -> packed words (little-endian within
    each word), as int32 holding the uint32 pattern. sums: (..., bits),
    bits % 32 == 0."""
    bits = (sums > 0).to(torch.int64)
    *lead, b = bits.shape
    words = bits.reshape(*lead, b // 32, 32)
    weights = torch.ones(32, dtype=torch.int64, device=sums.device) \
        << torch.arange(32, dtype=torch.int64, device=sums.device)
    return to_int32_bits((words * weights).sum(-1))


def unpack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed int32 words -> (..., bits) int32 in {0, 1}."""
    words = (codes.to(torch.int64) & MASK32)[..., :, None]
    shifts = torch.arange(32, dtype=torch.int64, device=codes.device)
    out = ((words >> shifts) & 1).to(torch.int32)
    return out.reshape(*codes.shape[:-1], codes.shape[-1] * 32)[..., :bits]


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of uint32 patterns held in int32 or int64 -> int32."""
    v = v.to(torch.int64) & MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((mul32(v, 0x01010101)) >> 24).to(torch.int32)


def batched_lsh_codes(flat2d: torch.Tensor, seed: int, *, bits: int = 256,
                      use_kernel: bool = True) -> torch.Tensor:
    """WPFed Eq. (5) over the stacked client axis: (M, P) f32 -> (M, W)
    packed codes. `use_kernel` goes through the kernel wrapper (CUDA
    kernel on a CUDA tensor), otherwise the plain version runs."""
    from repro_torch.kernels import lsh_projection, ref
    if use_kernel:
        sums = lsh_projection.lsh_project_sums_batched(flat2d, seed,
                                                       bits=bits)
    else:
        sums = ref.lsh_project_sums_batched_ref(flat2d, seed, bits=bits)
    return pack_bits(sums)


def lsh_code(params: Dict[str, torch.Tensor], seed: int, *, bits: int = 256,
             use_kernel: bool = True) -> torch.Tensor:
    """WPFed Eq. (5): the (W,) packed code of one client's params.
    `use_kernel` goes through the single-client kernel's wrapper."""
    from repro_torch.kernels import lsh_projection, ref
    flat = flatten_params(params)
    if use_kernel:
        sums = lsh_projection.lsh_project_sums(flat, seed, bits=bits)
    else:
        sums = ref.lsh_project_sums_ref(flat, seed, bits=bits)
    return pack_bits(sums)


def hamming_matrix(codes: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """WPFed Eq. (6) for all pairs: (M, W) packed codes -> (M, M) int32.
    No padding: the CUDA kernel takes any M and W."""
    from repro_torch.kernels import hamming, ref
    if use_kernel:
        return hamming.hamming_all_pairs(codes, codes)
    return ref.hamming_all_pairs_ref(codes, codes)

"""LSH similarity layer (WPFed §3.2, Eq. 5-6). Counterpart of
`repro/core/lsh.py`.

Per-client and batched codes of parameter dicts, and the unfused
all-pairs distance matrix and normalized distance that stay the
semantic reference for the fused selection (the round selects through
`core.neighbor.select_partners`). Distances are the bit fraction
d / bits (DESIGN.md §1). `sharded_lsh_code` computes the code of a
parameter vector sharded over ranks (beyond the paper, DESIGN.md §3):
each rank projects its own shard through the single-client kernel with
the shard's global row offset, and one all-reduce adds the partial sums,
so the whole vector never sits on one device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.analysis.privacy import declassifier
from repro_torch.core import backends
from repro_torch.kernels import lsh_projection, ops


def client_lsh_code(params: Dict[str, torch.Tensor], seed: int,
                    bits: int = 256, use_kernel: bool = True) -> torch.Tensor:
    """Eq. (5): the (W,) int32 packed code (uint32 patterns) of one
    client's {name: tensor} params, through the single-client kernel."""
    return ops.lsh_code(params, seed, bits=bits, use_kernel=use_kernel)


@declassifier(
    name="lsh-code", paper_eq="Eq. 5-6 (§3.2)",
    justification="sign-quantized random projection: each bit keeps one "
                  "sign of a Rademacher projection of the flattened "
                  "params — a locality hash for distance comparison, "
                  "not an invertible encoding of the model")
def stacked_lsh_codes(stacked_params: Dict[str, torch.Tensor], seed: int,
                      bits: int = 256, backend: str = "auto") -> torch.Tensor:
    """(M, W) int32 codes (uint32 patterns) of {name: (M, ...)} params,
    projected with the shared per-round seed. "ann" changes only the
    selection, so the projection resolves it as "auto"."""
    flat2d = ops.flatten_params_batched(stacked_params)
    use_kernel = backends.resolve("auto" if backend == "ann" else backend,
                                  flat2d.device) == "kernel"
    return ops.batched_lsh_codes(flat2d, seed, bits=bits,
                                 use_kernel=use_kernel)


def sharded_lsh_sums(local_shard: torch.Tensor, seed: int, bits: int,
                     group=None) -> torch.Tensor:
    """The (bits,) f32 Eq. 5 sums of a vector cut into equal consecutive
    shards, one per rank of `group` in rank order; `local_shard` is this
    rank's (n,) shard (a plain tensor: a DTensor's `.to_local()`). Every
    rank returns the sums.

    The rank hashes its shard as rows rank * n ... (mod 2^32) of R, the
    JAX `rademacher_block(idx * n, n, ...)`, through the single-client
    kernel's row offset, zero-padded to a CHUNK multiple (zeros add
    nothing); `all_reduce` adds the partial sums, where JAX `psum`s them.
    The projection is linear, so this is the projection of the whole
    vector up to f32 summation order."""
    n = local_shard.shape[0]
    x = local_shard.reshape(-1).to(torch.float32)
    if n % ops.CHUNK:
        x = F.pad(x, (0, (-n) % ops.CHUNK))
    partial = lsh_projection.lsh_project_sums(
        x.contiguous(), seed, bits=bits,
        row_offset=dist.get_rank(group) * n)
    dist.all_reduce(partial, group=group)
    return partial


def sharded_lsh_code(local_shard: torch.Tensor, seed: int, bits: int,
                     group=None) -> torch.Tensor:
    """The (W,) int32 code of `sharded_lsh_sums`: equal to the unsharded
    code except on sums within rounding of zero."""
    return ops.pack_bits(sharded_lsh_sums(local_shard, seed, bits, group))


def distance_matrix(codes: torch.Tensor, *,
                    use_kernel: bool = True) -> torch.Tensor:
    """Eq. (6) all pairs: (M, W) int32 codes -> (M, M) int32."""
    return ops.hamming_matrix(codes, use_kernel=use_kernel)


def normalized_distance(dist: torch.Tensor, bits: int) -> torch.Tensor:
    return dist.to(torch.float32) / float(bits)

"""Smoke run of the port's tiled kernels (the counterpart of
`scripts/tiled_smoke.py`): both tiled paths at shapes whose one-shot
kernel does not fit one H100 block's shared memory (`MAX_SHARED_BYTES`,
227 KB), so that `resolve_tiling("auto", ...)` takes them, held to their
contracts: the column-tiled selection bit-exact against its plain
version; the streamed exchange with the §3.5 mask equal and l_ij and
the target within rtol 2e-5, atol 1e-5 of both plain versions (the
streaming twin and the one-shot exchange's).

The JAX script sizes its shapes by the TPU's VMEM budget. The card's
one-shot selection holds a row of M weights (`oneshot_smem_bytes(m)` =
5 M bytes) up to M = 46,489, so selection runs at M = 65,536, the first
power of two past it. The card's one-shot exchange holds a client's
N x R rows (`oneshot_smem_bytes(n, r)`), whatever C is, so the exchange
runs at R = 4,096 reference rows with C cut to 1,024 classes, which keeps
the neighbour logits at 0.5 GB.

    PYTHONPATH=src python scripts/torch_tiled_smoke.py
    PYTHONPATH=src python scripts/torch_tiled_smoke.py --device cpu

Runs on the CUDA device unless `--device` names another; there it
launches the column-tiled selection kernel and the streamed exchange
kernels. Inputs are drawn from `torch.Generator`s on the CPU and moved
to the device. `main` returns each check's estimate and seconds.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import backends
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import MAX_SHARED_BYTES
from repro_torch.kernels.exchange import fused_exchange_streamed
from repro_torch.kernels.selection import fused_select_tiled

# the plain selection in 4096 x 4096 weight tiles: bit-equal to
# `fused_select_ref`, with temporaries of a few GB at M = 65,536
PLAIN_TILES = dict(block_m=4096, block_k=4096)


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def beyond_oneshot(est: int) -> None:
    """The one-shot estimate is past the budget and "auto" tiles."""
    assert est > MAX_SHARED_BYTES, (est, "not beyond one-shot")
    assert backends.resolve_tiling("auto", est) == "tiled"


def check_selection(codes, scores, n, bits):
    """The tiled selection, bit-exact against its plain version:
    (ids, weights, seconds of the tiled call)."""
    kw = dict(bits=bits, gamma=1.0, num_neighbors=n)
    _sync(codes.device)
    t0 = time.time()
    ids_t, w_t = fused_select_tiled(codes, scores, **kw)
    _sync(codes.device)
    t1 = time.time()
    lut = ref.selection_lut(codes.shape[1], bits, 1.0, device=codes.device)
    ids_o, w_o = ref.fused_select_tiled_ref(codes, scores, lut,
                                            num_neighbors=n, **PLAIN_TILES)
    assert torch.equal(ids_t, ids_o) and torch.equal(w_t, w_o), \
        "tiled selection diverged from the plain version"
    return ids_t, w_t, t1 - t0


def smoke_selection(m=65536, bits=256, n=16, device=None):
    est = backends.selection_oneshot_smem_bytes(m)
    beyond_oneshot(est)
    g = _generator(0)
    raw = torch.rand((m, bits), generator=g) < 0.5
    codes = ops.pack_bits(torch.where(raw, 1.0, -1.0)).to(device)
    scores = torch.rand((m,), generator=_generator(1)).to(device)
    _, _, seconds = check_selection(codes, scores, n, bits)
    print(f"selection M={m}: one-shot est {est >> 10} KiB > budget; "
          f"tiled {seconds:.1f}s, bit-exact OK")
    return {"m": m, "oneshot_smem_bytes": est, "tiled_s": seconds}


def check_exchange(own, nb, y, sel):
    """The streamed exchange against the streaming plain version and the
    one-shot exchange's: (outputs, seconds of the streamed call)."""
    _sync(own.device)
    t0 = time.time()
    out_s = fused_exchange_streamed(own, nb, y, sel)
    _sync(own.device)
    t1 = time.time()
    for other, tag in ((ref.streamed_exchange_ref(own, nb, y, sel), "twin"),
                       (ref.all_in_one_exchange_ref(own, nb, y, sel),
                        "one-shot plain version")):
        np.testing.assert_allclose(out_s[0].cpu().numpy(),
                                   other[0].cpu().numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=tag)
        assert torch.equal(out_s[1], other[1]), f"mask vs {tag}"
        np.testing.assert_allclose(out_s[2].cpu().numpy(),
                                   other[2].cpu().numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=tag)
        del other
    return out_s, t1 - t0


def smoke_exchange(m=4, n=8, r=4096, c=1024, device=None):
    est = backends.exchange_oneshot_smem_bytes(n, r)
    beyond_oneshot(est)
    g = _generator(2)
    own = (torch.randn((m, r, c), generator=g) * 3).to(device)
    nb = (torch.randn((m, n, r, c), generator=g) * 3).to(device)
    y = torch.randint(0, c, (m, r), generator=g).to(device)
    sel = (torch.rand((m, n), generator=g) < 0.8).to(device)
    _, seconds = check_exchange(own, nb, y, sel)
    print(f"exchange N={n} R={r} C={c}: one-shot est {est >> 10} KiB > "
          f"budget; streamed {seconds:.1f}s, contract OK")
    return {"n": n, "r": r, "c": c, "oneshot_smem_bytes": est,
            "streamed_s": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sel = smoke_selection(device=dev)
    exch = smoke_exchange(device=dev)
    print("tiled smoke OK")
    return {"selection": sel, "exchange": exch}


if __name__ == "__main__":
    main()

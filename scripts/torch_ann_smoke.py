"""Smoke run of the port's sub-quadratic ANN selection (the counterpart of
`scripts/ann_smoke.py`): `select_partners` with backend "ann" at an M
far beyond the exact kernels' comfortable range (the exact Gram at
M = 16,384 is 2.7e8 weight entries per pass; the ANN route prices
M * K with K << M), held to its contracts:

  * determinism: same seed, same partners (the protocol threads the
    round index, so reselection must be reproducible);
  * invariants at scale: self-mask, an all-True sel_mask, ids in range;
  * recall@N >= 0.9 against the exact plain selection on clustered
    codes at a mid-size M where the plain version still runs;
  * the prefix_bits=0 one-bucket fallback bit-exact against the exact
    one-shot kernel and its plain version.

    PYTHONPATH=src python scripts/torch_ann_smoke.py
    PYTHONPATH=src python scripts/torch_ann_smoke.py --device cpu

Runs on the CUDA device unless `--device` names another; there the ANN
route launches the grouped ANN selection kernel and the one-bucket check
the one-shot selection kernel. The codes and scores are drawn from
`torch.Generator`s on the CPU and moved to the device. `main` returns
the recall, K and the seconds of the M = 16,384 selection.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.paper_models import FedConfig
from repro_torch.core import ann, backends, neighbor
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selection import fused_select


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def clustered_codes(m, bits, n_clusters, flip=0.02, seed=0, device=None):
    """(M, bits / 32) packed codes: each a random cluster centre with
    `flip` of its bits flipped."""
    g = _generator(seed)
    centers = torch.rand((n_clusters, bits), generator=g) < 0.5
    assign = torch.randint(0, n_clusters, (m,), generator=g)
    flips = torch.rand((m, bits), generator=g) < flip
    raw = centers[assign] ^ flips
    return ops.pack_bits(torch.where(raw, 1.0, -1.0)).to(device)


def uniform(m, seed, device=None):
    return torch.rand((m,), generator=_generator(seed)).to(device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def scale_check(codes, scores, fed):
    """ANN selection of every client's partners, twice: (ids, seconds of
    the first call)."""
    m = codes.shape[0]
    _sync(codes.device)
    t0 = time.time()
    ids, mask = neighbor.select_partners(codes, scores, fed, backend="ann",
                                         seed=4)
    _sync(codes.device)
    t1 = time.time()
    ids2, _ = neighbor.select_partners(codes, scores, fed, backend="ann",
                                       seed=4)
    assert torch.equal(ids, ids2), "ann reselection not deterministic"
    assert bool(mask.all()), "teaser must keep every row served"
    row = torch.arange(m, dtype=torch.int32, device=codes.device)[:, None]
    assert not bool((ids == row).any()), "self selected"
    assert bool(((ids >= 0) & (ids < m)).all()), "id out of range"
    return ids, t1 - t0


def smoke_scale(m=16384, bits=256, n=12, prefix_bits=8, probes=6,
                device=None):
    """ANN selection at M = 16,384: a shape whose exact path would build
    a 16,384^2 weight matrix (1 GiB f32) per round."""
    fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits,
                    ann_prefix_bits=prefix_bits, ann_probes=probes)
    codes = clustered_codes(m, bits, m // 32, seed=1, device=device)
    scores = 0.75 + 0.25 * uniform(m, 2, device)
    k = ann.candidate_count(m, prefix_bits, probes, n, bits)
    _, seconds = scale_check(codes, scores, fed)
    print(f"ann selection M={m}: K={k} (vs exact M={m}), "
          f"{seconds:.1f}s, invariants OK")
    return {"m": m, "k": k, "select_s": seconds}


def recall_at_n(codes, scores, n, bits):
    """(recall@N of the ANN selection against the exact one, the
    candidate ids), both through the plain versions."""
    m = codes.shape[0]
    lut = ref.selection_lut(codes.shape[1], bits, 1.0, device=codes.device)
    ids_e, _ = ref.fused_select_ref(codes, scores, lut, num_neighbors=n)
    cand = ann.ann_candidates(codes, scores, seed=6, prefix_bits=7,
                              probes=7, num_neighbors=n)
    ids_a, _ = ref.ann_select_ref(codes, scores, cand.ids, lut,
                                  num_neighbors=n)
    e, a = ids_e.cpu().numpy(), ids_a.cpu().numpy()
    hits = sum(len(set(e[i]) & set(a[i])) for i in range(m))
    return hits / float(m * n), cand.ids


def smoke_recall(m=2048, bits=256, n=12, device=None):
    codes = clustered_codes(m, bits, m // 32, seed=3, device=device)
    scores = 0.75 + 0.25 * uniform(m, 5, device)
    recall, cand_ids = recall_at_n(codes, scores, n, bits)
    assert recall >= 0.9, f"recall@{n} = {recall:.3f} < 0.9"
    print(f"ann recall M={m}: recall@{n}={recall:.3f} "
          f"(K={cand_ids.shape[1]}) OK")
    return {"m": m, "recall": recall, "k": int(cand_ids.shape[1])}


def one_bucket_ids(codes, scores, n, bits):
    """prefix_bits=0 -> one bucket: the ANN route's ids, held bit-exact
    against the exact one-shot kernel and its plain version."""
    m = codes.shape[0]
    fed = FedConfig(num_clients=m, num_neighbors=n, lsh_bits=bits,
                    ann_prefix_bits=0, ann_probes=0)
    ids, _ = neighbor.select_partners(codes, scores, fed, backend="ann",
                                      seed=9)
    ids_k, _ = fused_select(codes, scores, bits=bits, gamma=fed.gamma,
                            num_neighbors=n)
    lut = ref.selection_lut(codes.shape[1], bits, fed.gamma,
                            device=codes.device)
    ids_o, _ = ref.fused_select_ref(codes, scores, lut, num_neighbors=n)
    assert torch.equal(ids, ids_k), "one-bucket != fused_select"
    assert torch.equal(ids, ids_o), "one-bucket != plain version"
    return ids


def smoke_one_bucket(m=256, bits=128, n=12, device=None):
    codes = clustered_codes(m, bits, m // 32, seed=7, device=device)
    scores = uniform(m, 8, device)
    one_bucket_ids(codes, scores, n, bits)
    print(f"ann one-bucket fallback M={m}: bit-exact vs exact kernels OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    assert backends.resolve_selection(
        "ann", 2, exact_flops=1.0, ann_flops=1.0, device=dev) == "ann"
    smoke_one_bucket(device=dev)
    recall = smoke_recall(device=dev)
    scale = smoke_scale(device=dev)
    print("ANN smoke OK")
    return {"recall": recall["recall"], "recall_k": recall["k"],
            "scale_m": scale["m"], "scale_k": scale["k"],
            "scale_select_s": scale["select_s"]}


if __name__ == "__main__":
    main()

"""Smoke run of the port's continuous federation service (the
counterpart of `scripts/service_smoke.py`), at fixture scale.

Runs a 3-period churned service (1 leave at period 1, 1 rejoin at
period 2) twice:

  A. straight through, and
  B. killed after period 2: a resume from a template state, everything
     else restored from disk by `resume_service`, finishes period 3.

Asserts:

  * the per-round metrics of B equal A's (==, not approximately; the
    wall "seconds" each round records are left out);
  * the final ServiceState of B is bitwise equal to A's;
  * `verify_chain` holds across the restart, and the two ledgers record
    the same protocol content (payloads; hashes differ by timestamps);
  * checkpoint retention pruned to keep_last_k snapshots;
  * the serving front answers batched requests from the live
    per-client personalized models, within 1e-5 of direct application.

    PYTHONPATH=src python scripts/torch_service_smoke.py
    PYTHONPATH=src python scripts/torch_service_smoke.py --device cpu

Runs on the CUDA device unless `--device` names another; there the
rounds launch the LSH, one-shot selection and one-shot exchange kernels.
The fixture's data are the JAX script's (numpy `RandomState(0)`); the
client weights are drawn from a `torch.Generator`. `main` returns the
server's throughput and the run's seconds.
"""
import argparse
import functools
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.paper_models import ClientModelConfig, FedConfig
from repro_torch.core import init_state
from repro_torch.core.protocol import client
from repro_torch.device import resolve_device
from repro_torch.models.client import (apply_client_model, client_template,
                                       init_client_model)
from repro_torch.optim import adam
from repro_torch.service import (ChurnEvent, PersonalizedServer,
                                 ServiceConfig, init_service_state,
                                 resume_service, run_service)
from repro_torch.tree import tree_leaves


def build(seed=0, m=6, d=16, classes=3, device=None):
    """The shared smoke fixture: (fed, apply_fn, init_fn, opt, data), the
    data as tensors on `device`."""
    rs = np.random.RandomState(seed)
    mcfg = ClientModelConfig("smoke-mlp", "mlp", (d,), classes,
                             hidden=(32,))
    fed = FedConfig(num_clients=m, num_neighbors=3, top_k=2,
                    local_steps=3, local_batch=16, lsh_bits=128, lr=1e-2)
    centers = rs.randn(classes, d) * 2.5

    def gen(n, props):
        y = rs.choice(classes, size=n, p=props)
        return (centers[y] + rs.randn(n, d)).astype("f"), y.astype("i4")

    packs = {k: [] for k in ("x_train", "y_train", "x_ref", "y_ref",
                             "x_test", "y_test")}
    for _ in range(m):
        props = rs.dirichlet(np.ones(classes) * 0.8)
        props = 0.7 * props + 0.3 / classes
        for split, (n, p) in {"train": (40, props),
                              "ref": (12, np.ones(classes) / classes),
                              "test": (20, props)}.items():
            x, y = gen(n, p)
            packs[f"x_{split}"].append(x)
            packs[f"y_{split}"].append(y)
    data = {k: torch.from_numpy(np.stack(v)).to(device)
            for k, v in packs.items()}
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    init_fn = lambda g: init_client_model(mcfg, g, device)  # noqa: E731
    return fed, apply_fn, init_fn, adam(fed.lr), data


def no_wall(hist):
    """A history without the wall seconds each round records."""
    return [{k: v for k, v in h.items() if k != "seconds"} for h in hist]


def same_state(a, b) -> bool:
    """Two state trees equal leaf for leaf, bit for bit."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fed, apply_fn, init_fn, opt, data = build(device=dev)
    svc = ServiceConfig(reselect_every=3, keep_last_k=2)
    events = [ChurnEvent(1, "leave", 4), ChurnEvent(2, "join", 4)]

    def fresh():
        return init_service_state(init_state(init_fn, opt, fed, 0), svc)

    with tempfile.TemporaryDirectory() as tmp:
        dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.time()
        s_a, chain_a, hist_a = run_service(
            apply_fn, opt, fed, svc, fresh(), data, periods=3,
            events=events, ckpt_dir=dir_a, log=print)
        assert chain_a.verify_chain(), "uninterrupted ledger broken"

        # run B: kill after period 2, resume from disk, finish
        run_service(apply_fn, opt, fed, svc, fresh(), data, periods=2,
                    events=events, ckpt_dir=dir_b)
        s_r, chain_r, p0 = resume_service(dir_b, fresh())
        assert p0 == 2, f"expected resume at period 2, got {p0}"
        s_b, chain_b, hist_tail = run_service(
            apply_fn, opt, fed, svc, s_r, data, periods=3,
            events=events, chain=chain_r, ckpt_dir=dir_b,
            start_period=p0, log=print)

        # acceptance: metric continuity, identical, not approximate
        tail_a = hist_a[-svc.reselect_every:]
        assert no_wall(hist_tail) == no_wall(tail_a), \
            "resumed metrics diverged"
        assert same_state(s_a, s_b), "resumed final state not bitwise equal"
        assert chain_b.verify_chain(), \
            "ledger fails verification across the restart boundary"
        assert [blk.payload for blk in chain_a.blocks] == \
            [blk.payload for blk in chain_b.blocks], \
            "resumed ledger recorded different protocol content"
        snaps = sorted(f for f in os.listdir(dir_b)
                       if f.endswith(".npz"))
        assert len(snaps) == svc.keep_last_k, \
            f"retention kept {snaps}, wanted {svc.keep_last_k}"

        # churn actually happened (period 1 ran 5/6 active)
        fracs = [h["active_frac"] for h in hist_a]
        assert fracs[0] == 1.0 and fracs[svc.reselect_every] < 1.0 \
            and fracs[-1] == 1.0, f"churn not visible: {fracs}"

        # the serving front, on the final personalized models
        server = PersonalizedServer(apply_fn, s_b.fed.params)
        for r in range(12):
            cid = r % fed.num_clients
            server.submit(cid, data["x_test"][cid, r % 20])
        got = server.flush()
        with torch.no_grad():
            direct = apply_fn(client(s_b.fed.params, 2),
                              data["x_test"][2, 2][None])[0]
        assert np.allclose(got[2], direct.cpu().numpy(), atol=1e-5), \
            "served logits diverge from direct application"
        stats = server.throughput()
        print(f"serving: {stats['requests']:.0f} requests, "
              f"{stats['requests_per_s']:.0f} req/s, "
              f"p50 {stats['p50_latency_s'] * 1e3:.2f} ms")
        wall = time.time() - t0
        print(f"service smoke OK ({wall:.1f}s): "
              "churned kill/resume run identical to uninterrupted, "
              "ledger verified across restart")
    return {"requests": stats["requests"],
            "requests_per_s": stats["requests_per_s"],
            "p50_latency_s": stats["p50_latency_s"], "wall_s": wall}


if __name__ == "__main__":
    main()

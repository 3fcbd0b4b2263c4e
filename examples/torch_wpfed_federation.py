"""End-to-end WPFed federation on the PyTorch port (the counterpart of
`examples/wpfed_federation.py`): 24 CNN clients x ~420k params trained
for a few hundred aggregate local steps on synthetic non-IID MNIST, with
the host ledger recording every reselection's announcements.

    PYTHONPATH=src python examples/torch_wpfed_federation.py [--rounds 12]
    PYTHONPATH=src python examples/torch_wpfed_federation.py --device cpu \\
        --rounds 4 --clients 8

Runs on the CUDA device unless `--device` names another. The weights
are drawn from a `torch.Generator` seeded `--seed`, so the trajectory
agrees with the JAX example's in distribution, not number for number
(`tests/test_torch_trajectory.py` holds one against the JAX package from
a carried-across state). The last line is the accuracy trajectory as
JSON.
"""
import argparse
import functools
import json

import torch

from repro_torch.configs.paper_models import (FedConfig, mnist_cnn,
                                              recommended_dedupe)
from repro_torch.core import (evaluate, init_state, resolve_schedule,
                              run_rounds, wpfed_program)
from repro_torch.core.chain import Blockchain
from repro_torch.data.federated import make_mnist_federated
from repro_torch.device import resolve_device
from repro_torch.launch.fed import chain_publisher
from repro_torch.models.client import (apply_client_model, client_template,
                                       init_client_model)
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernel", "oracle"],
                    help="selection + exchange backend: the CUDA kernels "
                         "or their plain PyTorch versions")
    ap.add_argument("--ref-mode", default="personal",
                    choices=["personal", "public"],
                    help="public: shared reference set, M forwards per "
                         "exchange instead of M*N; also enables the Eq. 7 "
                         "duplicate-evidence dedupe")
    ap.add_argument("--tiling", default="auto",
                    choices=["auto", "oneshot", "tiled"])
    ap.add_argument("--schedule", default="sync",
                    choices=["sync", "gossip"],
                    help="gossip: re-select every --reselect-every rounds, "
                         "cheap peer epochs in between")
    ap.add_argument("--reselect-every", type=int, default=0,
                    help="gossip period G (0 = schedule default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sched = resolve_schedule(args.schedule, args.reselect_every)

    fed = FedConfig(num_clients=args.clients, num_neighbors=6, top_k=4,
                    local_steps=args.local_steps, lsh_bits=256,
                    selection_backend=args.backend,
                    exchange_backend=args.backend, ref_mode=args.ref_mode,
                    selection_tiling=args.tiling,
                    exchange_tiling=args.tiling,
                    dedupe_rankings=recommended_dedupe(args.ref_mode))
    ds = make_mnist_federated(num_clients=args.clients, per_client=200,
                              ref_per_client=32)
    data = {k: torch.from_numpy(v).to(dev) for k, v in ds.stacked().items()}
    mcfg = mnist_cnn()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    opt = adam(fed.lr)
    state = init_state(lambda g: init_client_model(mcfg, g, dev), opt, fed,
                       args.seed)
    n_params = sum(t.numel() for t in state.params.values())
    print(f"{args.clients} clients x {n_params // args.clients:,} params = "
          f"{n_params:,} total; {args.rounds} rounds x {fed.local_steps} "
          f"local steps on {dev}")

    chain = Blockchain()
    state, history = run_rounds(
        wpfed_program(apply_fn, opt, fed), state, data,
        rounds=args.rounds, schedule=sched,
        eval_fn=lambda st, d: {"acc": evaluate(apply_fn, st, d)["mean_acc"]},
        on_reselect=chain_publisher(chain, args.clients),
        log=lambda line: print(line, flush=True))
    last = history[-1]
    print(f"final: acc {last['acc']:.4f} "
          f"verified {last['valid_neighbor_frac']:.2f}")
    if not chain.verify_chain():
        raise RuntimeError("ledger integrity violated")
    print(f"ledger: {len(chain.blocks)} blocks "
          f"({sched.reselect_every}-round periods), chain verified OK")
    print(json.dumps({"device": str(dev), "acc": [h["acc"] for h in history],
                      "seconds": [h["seconds"] for h in history]}))


if __name__ == "__main__":
    main()

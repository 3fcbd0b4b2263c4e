"""Federated launcher of the port: run the WPFed protocol on the card.
Counterpart of `repro/launch/fed.py` (`run_federation` and its CLI).

    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist --rounds 10
    PYTHONPATH=src python -m repro_torch.launch.fed --device cpu \
        --dataset aecg --clients 4 --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist \
        --rounds 2 --tiling tiled
    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist \
        --rounds 2 --backend ann --ann-prefix-bits 10 --ann-probes 8

Rounds run through `core.rounds.run_rounds`; every reselection is
published to a host `Blockchain`, verified before returning. The
JAX launcher's attacks, continuous service and sharded dry run are not
ported yet.
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.configs.paper_models import (FedConfig, PAPER_FED_OPTIMA,
                                              aecg_tcn, mnist_cnn,
                                              recommended_dedupe, seeg_tcn)
from repro_torch.core import (evaluate, init_state, resolve_schedule,
                              run_rounds, wpfed_program)
from repro_torch.core.chain import Blockchain, lsh_code_hex, sha256_commit
from repro_torch.data import DATASETS
from repro_torch.device import resolve_device
from repro_torch.models.client import (apply_client_model, client_template,
                                       init_client_model)
from repro_torch.optim import adam

MODEL_FOR = {"mnist": mnist_cnn, "aecg": aecg_tcn, "seeg": seeg_tcn}


def chain_publisher(chain: Blockchain, num_clients: int):
    """`on_reselect` callback: publish a reselection's announcements
    a_i = {lsh_i, C_i} plus the revealed rankings to the host ledger."""

    def publish(round_idx: int, state) -> None:
        codes = state.codes.cpu()
        rankings = state.rankings.cpu()
        ann = {i: {"lsh": lsh_code_hex(codes[i]),
                   "commit": sha256_commit(rankings[i])}
               for i in range(num_clients)}
        reveals = {i: rankings[i].tolist() for i in range(num_clients)}
        chain.publish_round(round_idx + 1, ann, reveals=reveals)

    return publish


def run_federation(dataset: str = "mnist", rounds: int = 10,
                   num_clients: int = 0, seed: int = 0, fed: FedConfig = None,
                   backend: str = "auto", ref_mode: str = "personal",
                   tiling: str = "auto", schedule: str = "sync",
                   reselect_every: int = 0, ann_prefix_bits: int = -1,
                   ann_probes: int = -1, device=None, log=print):
    """Run a federation on `device` (the CUDA device when None; the CPU
    only when asked). `backend` drives both kernel-backed subsystems
    (selection and exchange) and the LSH projection; "ann" applies to
    the selection only and leaves the exchange on "auto". `tiling`
    drives both tiling regimes; `ann_prefix_bits` / `ann_probes` (-1:
    the FedConfig defaults) the ANN index. An explicit `fed` wins
    outright: backend/ref_mode/tiling/ann knobs apply only to the
    default-constructed config. ref_mode "public" also enables the
    Eq. 7 duplicate-evidence dedupe. Returns (state, history)."""
    dev = resolve_device(device)
    if fed is not None and (backend != "auto" or ref_mode != "personal"
                            or tiling != "auto" or ann_prefix_bits >= 0
                            or ann_probes >= 0):
        raise ValueError("pass backend/ref_mode/tiling/ann knobs inside "
                         "the explicit FedConfig, not alongside it")
    sched = resolve_schedule(schedule, reselect_every)
    ds_fn = DATASETS[dataset]
    ds = ds_fn(seed=seed) if num_clients == 0 else \
        ds_fn(num_clients=num_clients, seed=seed)
    n_opt, alpha, gamma = PAPER_FED_OPTIMA[dataset]
    defaults = FedConfig()
    fed = fed or FedConfig(num_clients=ds.num_clients, num_neighbors=n_opt,
                           alpha=alpha, gamma=gamma, rounds=rounds,
                           selection_backend=backend,
                           exchange_backend="auto" if backend == "ann"
                           else backend, ref_mode=ref_mode,
                           selection_tiling=tiling, exchange_tiling=tiling,
                           dedupe_rankings=recommended_dedupe(ref_mode),
                           ann_prefix_bits=ann_prefix_bits
                           if ann_prefix_bits >= 0
                           else defaults.ann_prefix_bits,
                           ann_probes=ann_probes if ann_probes >= 0
                           else defaults.ann_probes)
    mcfg = MODEL_FOR[dataset]()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    opt = adam(fed.lr)
    data = {k: torch.from_numpy(v).to(dev) for k, v in ds.stacked().items()}
    state = init_state(lambda g: init_client_model(mcfg, g, dev), opt, fed,
                       seed)
    chain = Blockchain()
    state, history = run_rounds(
        wpfed_program(apply_fn, opt, fed), state, data, rounds=rounds,
        schedule=sched,
        eval_fn=lambda st, d: {"acc": evaluate(apply_fn, st, d)["mean_acc"]},
        on_reselect=chain_publisher(chain, fed.num_clients), log=log)
    if not chain.verify_chain():
        raise RuntimeError("host ledger integrity violated")
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "aecg", "seeg"])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernel", "oracle", "ann"],
                    help="kernel: the CUDA kernels; oracle: their plain "
                         "PyTorch versions; auto: kernel on a CUDA device "
                         "(ANN selection past 4096 clients); ann: "
                         "selection through the LSH-bucket candidate "
                         "index, exchange on auto")
    ap.add_argument("--ann-prefix-bits", type=int, default=-1,
                    help="ANN bucket prefix length (-1: FedConfig default; "
                         "0: one bucket, the exact selection)")
    ap.add_argument("--ann-probes", type=int, default=-1,
                    help="ANN single-bit probes, the recall knob (-1: "
                         "FedConfig default)")
    ap.add_argument("--ref-mode", default="personal",
                    choices=["personal", "public"])
    ap.add_argument("--tiling", default="auto",
                    choices=["auto", "oneshot", "tiled"],
                    help="oneshot: one block per row / client; tiled: the "
                         "column-tiled selection and streamed exchange; "
                         "auto: tiled past the one-shot kernels' shared "
                         "memory")
    ap.add_argument("--schedule", default="sync", choices=["sync", "gossip"])
    ap.add_argument("--reselect-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    _, history = run_federation(args.dataset, args.rounds,
                                num_clients=args.clients, seed=args.seed,
                                backend=args.backend, ref_mode=args.ref_mode,
                                tiling=args.tiling, schedule=args.schedule,
                                reselect_every=args.reselect_every,
                                ann_prefix_bits=args.ann_prefix_bits,
                                ann_probes=args.ann_probes,
                                device=args.device)
    scalars = [{k: v for k, v in h.items() if not isinstance(v, list)}
               for h in history[-3:]]
    print(json.dumps(scalars, indent=1))


if __name__ == "__main__":
    main()

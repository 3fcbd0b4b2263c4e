"""Attack resilience on the PyTorch port (paper §4.7-4.8; the counterpart
of `examples/attack_resilience.py`): the LSH-cheating attack against
WPFed, with and without the trust-free defences, as a
`core.adversary.ThreatModel` run through the round-program engine, so
`--reselect-every G` gossips between reselections with the attack still
firing inside each gossip epoch.

    PYTHONPATH=src python examples/torch_attack_resilience.py
    PYTHONPATH=src python examples/torch_attack_resilience.py \\
        --clients 6 --rounds 3 --per-client 48 --reselect-every 3 \\
        --device cpu                                   # reduced (CI smoke)

Runs on the CUDA device unless `--device` names another; there each
round launches the LSH, one-shot selection and one-shot exchange
kernels. The weights and the attackers' fresh draws come from
`torch.Generator`s, so the accuracies agree with the JAX example's in
distribution, not number for number. Prints the two-column table and
the final honest accuracies; the last line is both trajectories as
JSON, which `main` returns.
"""
import argparse
import functools
import json

import torch

from repro_torch.configs.paper_models import FedConfig, mnist_cnn
from repro_torch.core import (Schedule, evaluate, init_state,
                              instrument_program, resolve_attack,
                              run_rounds, threat_model, wpfed_program)
from repro_torch.data.federated import make_mnist_federated
from repro_torch.device import resolve_device
from repro_torch.models.client import (apply_client_model, client_template,
                                       init_client_model)
from repro_torch.optim import adam


def run(lsh_verification: bool, *, clients=8, rounds=6, attack_at=2,
        per_client=100, reselect_every=1, device=None):
    n_nb = min(4, clients - 1)
    fed = FedConfig(num_clients=clients, num_neighbors=n_nb,
                    top_k=max(2, n_nb - 1), local_steps=2, lsh_bits=128,
                    lsh_verification=lsh_verification)
    ds = make_mnist_federated(num_clients=clients, per_client=per_client,
                              ref_per_client=16)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in ds.stacked().items()}
    mcfg = mnist_cnn()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    init_fn = lambda g: init_client_model(mcfg, g, device)  # noqa: E731
    opt = adam(fed.lr)
    state = init_state(init_fn, opt, fed, 0)

    # half the pool corrupts its params and forges the target's LSH
    # code, every round from attack_at
    tm = threat_model(
        [resolve_attack("corrupt", init_fn=init_fn, start_round=attack_at),
         resolve_attack("forge_codes", target_id=0, start_round=attack_at)],
        torch.arange(clients) >= clients // 2, seed=9, name="lsh-cheat")
    program = instrument_program(wpfed_program(apply_fn, opt, fed), tm)
    honest = (~tm.attacker_mask).to(torch.float32)
    eval_fn = lambda st, d: {"acc": evaluate(  # noqa: E731
        apply_fn, st, d, honest_mask=honest)["mean_acc"]}
    _state, history = run_rounds(program, state, data, rounds=rounds,
                                 schedule=Schedule(reselect_every),
                                 eval_fn=eval_fn)
    return [h["acc"] for h in history]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--attack-at", type=int, default=2)
    ap.add_argument("--per-client", type=int, default=100)
    ap.add_argument("--reselect-every", type=int, default=1,
                    help="gossip period G (attacks fire inside the "
                         "gossip epochs too)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    kw = dict(clients=args.clients, rounds=args.rounds,
              attack_at=args.attack_at, per_client=args.per_client,
              reselect_every=args.reselect_every,
              device=resolve_device(args.device))
    print("LSH-cheating attack from round", args.attack_at)
    with_v = run(lsh_verification=True, **kw)
    without_v = run(lsh_verification=False, **kw)
    print(f"{'round':>5s} {'WPFed (verified)':>18s} {'no verification':>16s}")
    for r, (a, b) in enumerate(zip(with_v, without_v)):
        mark = "  <- attack on" if r >= args.attack_at else ""
        print(f"{r:5d} {a:18.4f} {b:16.4f}{mark}")
    print(f"\nfinal honest-client accuracy: verified={with_v[-1]:.4f} "
          f"vs unverified={without_v[-1]:.4f}")
    result = {"verified": with_v, "unverified": without_v}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

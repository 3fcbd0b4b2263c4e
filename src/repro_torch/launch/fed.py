"""Federated launcher of the port: run the WPFed protocol on the card.
Counterpart of `repro/launch/fed.py` (`run_federation` and its CLI).

    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist --rounds 10
    PYTHONPATH=src python -m repro_torch.launch.fed --device cpu \
        --dataset aecg --clients 4 --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist \
        --rounds 2 --tiling tiled
    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist \
        --rounds 2 --backend ann --ann-prefix-bits 10 --ann-probes 8
    PYTHONPATH=src python -m repro_torch.launch.fed --dataset mnist \
        --rounds 3 --attack lsh_cheat --attack-start 0
    PYTHONPATH=src python -m repro_torch.launch.fed --device cpu \
        --service --dataset aecg --clients 4 --periods 2 \
        --churn "1:leave:2" --faults "seed=7,drop=0.1,crash=1" \
        --ckpt-dir /tmp/svc [--resume]

Rounds run through `core.rounds.run_rounds`; every reselection is
published to a host `Blockchain`, verified before returning. `--attack`
instruments the round program with one of the paper's threat models
(`core.adversary.resolve_threat`); accuracy is then the honest
cohort's. The baselines are built by `core.rounds.make_program`, as in
the JAX package. `--service` runs the continuous federation service
instead (`run_service_federation`, `repro_torch.service`): reselection
periods with churn, per-client gossip budgets, staleness-discounted
selection, checkpoints a killed service resumes from bit for bit, and
deterministic fault injection. The JAX launcher's sharded dry run is not
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
from repro_torch.core import (evaluate, init_state, instrument_program,
                              resolve_schedule, resolve_threat, run_rounds,
                              wpfed_program)
from repro_torch.core.adversary import THREATS
from repro_torch.core.chain import Blockchain, lsh_code_hex, sha256_commit
from repro_torch.data import DATASETS
from repro_torch.device import resolve_device
from repro_torch.models.client import (apply_client_model, client_template,
                                       init_client_model)
from repro_torch.optim import adam
from repro_torch.service import (ServiceConfig, init_service_state,
                                 parse_events, parse_fault_spec,
                                 resume_service, run_service)

MODEL_FOR = {"mnist": mnist_cnn, "aecg": aecg_tcn, "seeg": seeg_tcn}


def chain_publisher(chain: Blockchain, num_clients: int):
    """`on_reselect` callback: publish a reselection's announcements
    a_i = {lsh_i, C_i} plus the revealed rankings to the host ledger."""

    def publish(round_idx: int, state) -> None:
        codes = state.codes.cpu()  # analysis: host-ok the ledger's copy
        rankings = state.rankings.tolist()  # analysis: host-ok reveals
        ann = {i: {"lsh": lsh_code_hex(codes[i]),
                   "commit": sha256_commit(rankings[i])}
               for i in range(num_clients)}
        reveals = {i: rankings[i] for i in range(num_clients)}
        chain.publish_round(round_idx + 1, ann, reveals=reveals)

    return publish


def run_federation(dataset: str = "mnist", rounds: int = 10,
                   num_clients: int = 0, seed: int = 0, fed: FedConfig = None,
                   backend: str = "auto", ref_mode: str = "personal",
                   tiling: str = "auto", schedule: str = "sync",
                   reselect_every: int = 0, attack: str = "none",
                   attack_frac: float = 0.5, attack_start: int = -1,
                   ann_prefix_bits: int = -1, ann_probes: int = -1,
                   device=None, log=print):
    """Run a federation on `device` (the CUDA device when None; the CPU
    only when asked). `backend` drives both kernel-backed subsystems
    (selection and exchange) and the LSH projection; "ann" applies to
    the selection only and leaves the exchange on "auto". `tiling`
    drives both tiling regimes; `ann_prefix_bits` / `ann_probes` (-1:
    the FedConfig defaults) the ANN index. An explicit `fed` wins
    outright: backend/ref_mode/tiling/ann knobs apply only to the
    default-constructed config. ref_mode "public" also enables the
    Eq. 7 duplicate-evidence dedupe. `attack` (one of THREATS, or
    "none") instruments the program with `resolve_threat` (seed + 31,
    attackers the last int(M * attack_frac) clients; `attack_start=-1`
    keeps the threat's default start, e.g. the §4.8 warm-up), and the
    accuracy is then the honest cohort's. Returns (state, history)."""
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
    init_fn = lambda g: init_client_model(mcfg, g, dev)  # noqa: E731
    state = init_state(init_fn, opt, fed, seed)
    program = wpfed_program(apply_fn, opt, fed)
    honest_mask = None
    if attack != "none":
        tm = resolve_threat(
            attack, num_clients=fed.num_clients, attacker_frac=attack_frac,
            init_fn=init_fn, seed=seed + 31,
            start_round=None if attack_start < 0 else attack_start)
        program = instrument_program(program, tm)
        honest_mask = ~tm.attacker_mask
    chain = Blockchain()
    state, history = run_rounds(
        program, state, data, rounds=rounds, schedule=sched,
        eval_fn=lambda st, d: {"acc": evaluate(
            apply_fn, st, d, honest_mask=honest_mask)["mean_acc"]},
        on_reselect=chain_publisher(chain, fed.num_clients), log=log)
    if not chain.verify_chain():
        raise RuntimeError("host ledger integrity violated")
    return state, history


def run_service_federation(dataset: str = "mnist", periods: int = 3,
                           reselect_every: int = 4, num_clients: int = 0,
                           seed: int = 0, churn: str = "",
                           gossip_counts: str = "",
                           staleness_lambda: float = 0.5,
                           checkpoint_every: int = 1, keep_last_k: int = 3,
                           ckpt_dir: str = None, resume: bool = False,
                           faults: str = "", device=None, log=print):
    """The continuous service: `run_federation`'s construction (the
    paper's FedConfig for `dataset`, default backends) driven by
    `repro_torch.service.run_service` instead of run_rounds: reselection
    periods of `reselect_every` rounds, churn events between them
    (`churn` = "period:kind:client,..."), per-client gossip budgets
    (`gossip_counts` = a comma list of G_i), durable checkpoints under
    `ckpt_dir`, `resume` picking a killed service up from its latest
    readable snapshot (bit for bit, checked against the recovered ledger)
    and `faults` (a `core.faults.parse_fault_spec` string, e.g.
    "seed=7,drop=0.1,straggle=0.2") running it under deterministic fault
    injection. Evaluation is the active cohort's mean accuracy. On the
    card, cuDNN is held to deterministic algorithms, so a resumed run
    equals the uninterrupted one bit for bit. Returns (state, chain,
    history)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.deterministic = True
    ds_fn = DATASETS[dataset]
    ds = ds_fn(seed=seed) if num_clients == 0 else \
        ds_fn(num_clients=num_clients, seed=seed)
    n_opt, alpha, gamma = PAPER_FED_OPTIMA[dataset]
    fed = FedConfig(num_clients=ds.num_clients, num_neighbors=n_opt,
                    alpha=alpha, gamma=gamma,
                    rounds=periods * reselect_every)
    svc = ServiceConfig(reselect_every=reselect_every,
                        staleness_lambda=staleness_lambda,
                        checkpoint_every=checkpoint_every,
                        keep_last_k=keep_last_k)
    mcfg = MODEL_FOR[dataset]()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    opt = adam(fed.lr)
    data = {k: torch.from_numpy(v).to(dev) for k, v in ds.stacked().items()}
    counts = [int(c) for c in gossip_counts.split(",")] \
        if gossip_counts else None
    template = init_service_state(
        init_state(lambda g: init_client_model(mcfg, g, dev), opt, fed,
                   seed), svc, gossip_counts=counts)
    if resume:
        if not ckpt_dir:
            raise ValueError("--resume needs --ckpt-dir")
        state, chain, start_period = resume_service(ckpt_dir, template)
    else:
        state, chain, start_period = template, Blockchain(), 0
    state, chain, history = run_service(
        apply_fn, opt, fed, svc, state, data, periods=periods,
        events=parse_events(churn) if churn else [], chain=chain,
        ckpt_dir=ckpt_dir, start_period=start_period,
        faults=parse_fault_spec(faults) if faults else None,
        eval_fn=lambda st, d: {"acc": evaluate(
            apply_fn, st.fed, d, honest_mask=st.active)["mean_acc"]},
        log=log)
    if not chain.verify_chain():
        raise RuntimeError("host ledger integrity violated")
    return state, chain, history


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
    ap.add_argument("--attack", default="none",
                    choices=("none",) + THREATS,
                    help="threat model instrumenting the run "
                         "(core.adversary.resolve_threat)")
    ap.add_argument("--attack-frac", type=float, default=0.5,
                    help="fraction of clients that attack (the tail of "
                         "the client axis)")
    ap.add_argument("--attack-start", type=int, default=-1,
                    help="first attacked round (-1: the threat's default, "
                         "e.g. poison's §4.8 warm-up)")
    ap.add_argument("--service", action="store_true",
                    help="run the continuous federation service "
                         "(repro_torch.service) instead of a fixed-round "
                         "experiment")
    ap.add_argument("--periods", type=int, default=3,
                    help="[service] reselection periods to run")
    ap.add_argument("--churn", default="",
                    help="[service] churn events as "
                         "'period:kind:client,...' e.g. "
                         "'1:leave:4,2:join:5'")
    ap.add_argument("--gossip-counts", default="",
                    help="[service] per-client gossip budgets G_i as a "
                         "comma list (default: the full period for all)")
    ap.add_argument("--staleness-lambda", type=float, default=0.5,
                    help="[service] Eq. 8 staleness discount "
                         "exp(-lambda * code_age)")
    ap.add_argument("--ckpt-dir", default="",
                    help="[service] checkpoint directory (durable state "
                         "+ chain.json)")
    ap.add_argument("--keep-last-k", type=int, default=3,
                    help="[service] checkpoint retention")
    ap.add_argument("--resume", action="store_true",
                    help="[service] resume from the latest checkpoint in "
                         "--ckpt-dir")
    ap.add_argument("--faults", default="",
                    help="[service] deterministic fault-injection spec "
                         "'seed=7,drop=0.1,delay=0.1,corrupt=0.1,"
                         "straggle=0.2,publish_fail=0.3,crash=2,fork=1' "
                         "(core.faults.parse_fault_spec)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.service:
        _, _, history = run_service_federation(
            args.dataset, periods=args.periods,
            reselect_every=args.reselect_every or 4,
            num_clients=args.clients, seed=args.seed, churn=args.churn,
            gossip_counts=args.gossip_counts,
            staleness_lambda=args.staleness_lambda,
            keep_last_k=args.keep_last_k, ckpt_dir=args.ckpt_dir or None,
            resume=args.resume, faults=args.faults, device=args.device)
        scalars = [{k: v for k, v in h.items() if not isinstance(v, list)}
                   for h in history[-3:]]
        print(json.dumps(scalars, indent=1))
        return
    _, history = run_federation(args.dataset, args.rounds,
                                num_clients=args.clients, seed=args.seed,
                                backend=args.backend, ref_mode=args.ref_mode,
                                tiling=args.tiling, schedule=args.schedule,
                                reselect_every=args.reselect_every,
                                attack=args.attack,
                                attack_frac=args.attack_frac,
                                attack_start=args.attack_start,
                                ann_prefix_bits=args.ann_prefix_bits,
                                ann_probes=args.ann_probes,
                                device=args.device)
    scalars = [{k: v for k, v in h.items() if not isinstance(v, list)}
               for h in history[-3:]]
    print(json.dumps(scalars, indent=1))


if __name__ == "__main__":
    main()

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
deterministic fault injection.

`--dryrun` runs one WPFed reselection period with transformer clients
(`dryrun_fed_round`): 256 by default, each a reduced phi3-medium-14b in
bf16, on the card. The JAX launcher only lowers and compiles that period
on its 16x16 mesh; here one card holds the whole federation, so the
period runs. Its JSON has the JAX dry run's keys (`flops_per_device` the
segment's FLOPs over the 16 data shards, `temp_bytes` the segment's peak
allocation beyond state and data) and the port's own (`flops`, `wall_s`
of the timed segment, `peak_bytes`, `state_bytes`):

    PYTHONPATH=src python -m repro_torch.launch.fed --dryrun
    PYTHONPATH=src python -m repro_torch.launch.fed --dryrun --clients 1024 \
        --ref-mode public --tiling tiled
    PYTHONPATH=src python -m repro_torch.launch.fed --dryrun --device cpu \
        --clients 16
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.paper_models import (FedConfig, PAPER_FED_OPTIMA,
                                              aecg_tcn, mnist_cnn,
                                              recommended_dedupe, seeg_tcn)
from repro_torch.core import (evaluate, init_state, instrument_program,
                              make_segment_fn, resolve_schedule,
                              resolve_threat, run_rounds, wpfed_program)
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
from repro_torch.tree import (dotted_names, flatten_dotted, tree_leaves,
                              tree_map, tree_unflatten)

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


# ---------------------------------------------------------------------------
# the dry run: one reselection period with transformer clients
# ---------------------------------------------------------------------------
def lm_client_fns(cfg, device, dtype=torch.bfloat16, draw_device=None):
    """(apply_fn, init_fn) of a transformer client in the federation.

    A client's params are the flat {dotted name: tensor} dict the round
    takes (`tree.flatten_dotted` of the `init_params` tree: sorted by
    `ops.leaf_key`, the names give `jax.tree.leaves` order, so the Eq. 5
    codes of the same weights equal the JAX package's). `apply_fn(params,
    tokens)` rebuilds the tree and returns the last position's logits
    (B, V) in f32, classifying the next token, as the JAX dry run does.
    Under no_grad (the exchange) attention takes the flash kernel; with
    grad enabled (the update) the differentiable route, since the kernel
    has no backward. The round calls `apply_fn` under `torch.func.vmap`
    over the clients (and over their neighbours), where flash launches
    once per vmapped call through its op's vmap rule, and under
    `torch.func.grad` in the update. `init_fn(generator)` draws one client's
    `init_params(cfg, g, dtype)` with a generator on `draw_device`
    (default `device`) seeded by one draw from `generator`: a thousand
    reduced-phi3 clients are 1.6e9 truncated normals, tens of seconds on
    a host's generator (`PERF.md`). The weights then follow the
    generator of `draw_device`, so two runs draw the same weights only
    when both draw there."""
    from repro_torch.models.transformer import forward, init_params, \
        meta_params
    like = meta_params(cfg)
    names = dotted_names(like)
    dev = torch.device(device)
    draw = torch.device(draw_device) if draw_device is not None else dev

    def apply_fn(params, tokens):
        tree = tree_unflatten(like, [params[n] for n in names])
        logits, _ = forward(cfg, tree, tokens,
                            differentiable=torch.is_grad_enabled())
        return logits[:, -1, :].to(torch.float32)

    def init_fn(generator):
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        g = torch.Generator(device=draw)
        g.manual_seed(seed)
        return {k: v.to(dev) for k, v in flatten_dotted(
            init_params(cfg, g, dtype)).items()}

    return apply_fn, init_fn


class FedDryrun(NamedTuple):
    """A dry run's federation, ready to run (`prepare_fed_dryrun`)."""
    cfg: Any                   # the clients' ModelConfig
    fed: FedConfig
    apply_fn: Callable
    optimizer: Any
    segment_fn: Callable       # one reselection period
    state: Any                 # FedState of the M clients
    data: Dict[str, torch.Tensor]
    device: torch.device
    shards: int                # the mesh's data axis: JAX's client shards
    report: Dict[str, Any]     # the JAX dry run's leading JSON keys


DRYRUN_SEQ, DRYRUN_REF, DRYRUN_LOCAL = 32, 8, 64


def prepare_fed_dryrun(num_clients: int = 256,
                       arch: str = "phi3-medium-14b",
                       backend: str = "kernel", ref_mode: str = "personal",
                       tiling: str = "auto", reselect_every: int = 1,
                       attack: str = "none", attack_frac: float = 0.5,
                       attack_start: int = -1, *, device=None, seed: int = 0,
                       draw_device=None) -> FedDryrun:
    """The JAX dry run's federation on `device` (the card when None):
    `get_config(arch).reduced()` clients in bf16, `FedConfig(N 8, top_k
    4, local_steps 1, lsh_bits 128, ref_batch 8)` with `backend` for the
    selection (and the exchange, which takes "kernel" when the selection
    is "ann"), `recommended_dedupe(ref_mode)`, `attack` instrumenting
    the program (seed 1), and data drawn from `seed` on `draw_device`
    (default `device`): x_train (M, 64, 32), y_train (M, 64), x_ref
    (M, 8, 32), y_ref (M, 8), tokens and labels in [0, vocab). The
    clients are drawn by `lm_client_fns`' init_fn from a generator
    seeded `seed`. On the CPU, "kernel" takes the kernels' plain
    versions, as every wrapper does for CPU tensors. M must divide by
    the mesh's data axis (16), whose shards JAX lays the clients on."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import axis_sizes, make_production_mesh
    dev = resolve_device(device)
    mesh = make_production_mesh()
    shards = axis_sizes(mesh)["data"]
    if num_clients % shards:
        raise ValueError(f"{num_clients} clients do not divide over the "
                         f"mesh's {shards} data shards")
    cfg = get_config(arch).reduced()

    def on_dev(b):                  # the plain versions on the CPU
        return "auto" if b == "kernel" and dev.type != "cuda" else b

    fed = FedConfig(num_clients=num_clients, num_neighbors=8, top_k=4,
                    local_steps=1, lsh_bits=128, ref_batch=DRYRUN_REF,
                    selection_backend=on_dev(backend),
                    exchange_backend=on_dev("kernel" if backend == "ann"
                                            else backend),
                    ref_mode=ref_mode, selection_tiling=tiling,
                    exchange_tiling=tiling,
                    dedupe_rankings=recommended_dedupe(ref_mode))
    apply_fn, init_fn = lm_client_fns(cfg, dev, draw_device=draw_device)
    opt = adam(fed.lr)
    program = wpfed_program(apply_fn, opt, fed)
    if attack != "none":
        program = instrument_program(program, resolve_threat(
            attack, num_clients=num_clients, attacker_frac=attack_frac,
            init_fn=init_fn, seed=1,
            start_round=None if attack_start < 0 else attack_start))
    state = init_state(init_fn, opt, fed, seed)
    draw = torch.device(draw_device) if draw_device is not None else dev
    g = torch.Generator(device=draw)
    g.manual_seed(seed)
    m, v = num_clients, cfg.vocab_size

    def ints(*shape):
        return torch.randint(0, v, shape, generator=g, device=draw,
                             dtype=torch.int32).to(dev)

    data = {"x_train": ints(m, DRYRUN_LOCAL, DRYRUN_SEQ),
            "y_train": ints(m, DRYRUN_LOCAL),
            "x_ref": ints(m, DRYRUN_REF, DRYRUN_SEQ),
            "y_ref": ints(m, DRYRUN_REF)}
    report = {"fed_round_clients": m, "client_arch": cfg.name,
              "ref_mode": ref_mode, "tiling": tiling,
              "reselect_every": reselect_every, "attack": attack,
              "mesh": "x".join(map(str, mesh.shape))}
    return FedDryrun(cfg, fed, apply_fn, opt,
                     make_segment_fn(program, reselect_every), state, data,
                     dev, shards, report)


def _on_meta(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def client_flops(dr: FedDryrun) -> Dict[str, int]:
    """FLOPs of one client's forward on a reference batch (R, 32) as the
    exchange runs it, and of one local step (`protocol.local_update`: the
    forwards on a minibatch and the reference batch, the backward, the
    Adam update), each counted alone by FlopCounterMode on meta, where
    nothing runs and every device counts alike. The counter sees matrix
    products, not elementwise work. The exchange's attention is the flash
    kernel, whose work is its formula, 4 * B * H * (causal pairs) * dh
    (`flash_attention.attention_flops`, the bound's work in chip_smoke.py)
    in place of its plain version's count; the update's attention is the
    plain differentiable route and counts as it runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.protocol import client, local_update
    from repro_torch.kernels.flash_attention import (attention_flops,
                                                     plain_gqa_attention)
    cfg, fed = dr.cfg, dr.fed
    params = _on_meta(client(dr.state.params, 0))
    tokens = torch.empty((fed.ref_batch, DRYRUN_SEQ), dtype=torch.int32,
                         device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        dr.apply_fn(params, tokens)
    dtype = next(iter(params.values())).dtype
    dh = cfg.resolved_head_dim
    q = torch.empty((fed.ref_batch, DRYRUN_SEQ, cfg.num_heads, dh),
                    dtype=dtype, device="meta")
    kv = torch.empty((fed.ref_batch, DRYRUN_SEQ, cfg.num_kv_heads, dh),
                     dtype=dtype, device="meta")
    with FlopCounterMode(display=False) as plain:
        plain_gqa_attention(q, kv, kv, True, 0.0)
    if cfg.is_encdec or cfg.vision_tokens:
        raise ValueError(f"{cfg.name}: the dry run's clients are decoder-"
                         "only token models")
    flash = [cfg.block_pattern[i % len(cfg.block_pattern)]    # causal "A"
             for i in range(cfg.num_layers)].count("A")
    forward = (fwd.get_total_flops()
               + flash * (attention_flops(fed.ref_batch, cfg.num_heads,
                                          DRYRUN_SEQ, DRYRUN_SEQ, dh, True)
                          - plain.get_total_flops()))
    mb = min(fed.local_batch, DRYRUN_LOCAL)
    data_i = {"x_train": torch.empty((DRYRUN_LOCAL, DRYRUN_SEQ),
                                     dtype=torch.int32, device="meta"),
              "y_train": torch.empty((DRYRUN_LOCAL,), dtype=torch.int32,
                                     device="meta"),
              "x_ref": tokens}
    with FlopCounterMode(display=False) as step:
        local_update(dr.apply_fn, dr.optimizer,
                     dataclasses.replace(fed, local_steps=1), params,
                     _on_meta(client(dr.state.opt_state, 0)),
                     data_i, torch.empty((fed.ref_batch, cfg.vocab_size),
                                         device="meta"),
                     torch.empty((), dtype=torch.bool, device="meta"),
                     torch.empty((1, mb), dtype=torch.int64, device="meta"))
    return {"forward": int(forward), "local_step": int(step.get_total_flops())}


def segment_flops(dr: FedDryrun) -> Dict[str, int]:
    """The segment's FLOPs ("total"), by part ("parts") and per unit
    ("forward", "local_step"): `reselect_every` exchanges of M own
    forwards (personal mode also M * N neighbour forwards) and updates of
    M * local_steps local steps (`client_flops`; every client computes
    its update), and one announce, whose LSH projection is 2 * M * P *
    bits (`lsh_projection.projection_flops`, P the padded parameter
    count). The selection kernels' Hamming work is integer and the
    exchange kernel's elementwise, so neither adds FLOPs, as no
    elementwise op does under FlopCounterMode."""
    from repro_torch.kernels import lsh_projection, ops
    fed, m = dr.fed, dr.fed.num_clients
    per = client_flops(dr)
    g = dr.report["reselect_every"]
    n = min(fed.num_neighbors, m - 1)
    fwd = m + (m * n if fed.ref_mode == "personal" else 0)
    p = sum(t[0].numel() for t in dr.state.params.values())
    p += (-p) % ops.CHUNK
    parts = {"forwards": g * fwd * per["forward"],
             "local_steps": g * m * fed.local_steps * per["local_step"],
             "lsh_projection": lsh_projection.projection_flops(
                 m, p, fed.lsh_bits)}
    return {"total": sum(parts.values()), "parts": parts, **per}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_fed_dryrun(dr: FedDryrun, *, warmup: int = 1, log=print):
    """Run `warmup` segments (the first at a size grows the allocator's
    pool and picks the kernels' plans; each is timed into `warmup_s`),
    then the timed one (`wall_s`; with warmup 0 it is itself the first),
    and return (the JSON report, the final state). `flops_per_device` is
    `flops` over the mesh's 16 data shards, as JAX splits the clients
    over "data" and leaves "model" unsharded; `temp_bytes` the timed
    segment's peak allocation beyond what was allocated as it began
    (its input state, the data, and what the caller holds, such as the
    initial state after a warm-up), `peak_bytes` that peak itself; both
    None off the card."""
    state, r0, warm_s = dr.state, 0, []
    cuda = dr.device.type == "cuda"
    if cuda:            # a segment ends synchronised, so once is enough
        torch.cuda.synchronize(dr.device)  # analysis: host-ok the clock
    for _ in range(warmup):
        t0 = time.perf_counter()
        state, _ = dr.segment_fn(state, dr.data, r0)
        warm_s.append(time.perf_counter() - t0)
        r0 += dr.report["reselect_every"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dr.device)
        start = torch.cuda.memory_allocated(dr.device)
    state_bytes = _nbytes(state)
    data_bytes = _nbytes(dr.data)
    t0 = time.perf_counter()
    state, metrics = dr.segment_fn(state, dr.data, r0)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dr.device) if cuda else None
    flops = segment_flops(dr)
    report = {**dr.report, "flops_per_device": flops["total"] / dr.shards,
              "temp_bytes": peak - start if cuda else None, "ok": True,
              "device": str(dr.device), "flops": flops["total"],
              "flops_by_part": flops["parts"],
              "flops_per_forward": flops["forward"],
              "flops_per_local_step": flops["local_step"],
              "warmup_segments": warmup, "warmup_s": warm_s,
              "wall_s": wall,
              "round_s": [m["seconds"] for m in metrics],
              "peak_bytes": peak, "state_bytes": state_bytes,
              "data_bytes": data_bytes}
    if log is not None:
        log(json.dumps(report, indent=1))
    return report, state


def dryrun_fed_round(num_clients: int = 256, arch: str = "phi3-medium-14b",
                     backend: str = "kernel", ref_mode: str = "personal",
                     tiling: str = "auto", reselect_every: int = 1,
                     attack: str = "none", attack_frac: float = 0.5,
                     attack_start: int = -1, *, device=None, seed: int = 0,
                     warmup: int = 1, log=print):
    """One WPFed reselection period with reduced-transformer clients,
    run on one card (the port of `repro/launch/fed.py:dryrun_fed_round`;
    the arguments are the JAX function's, plus `device`, `seed` and
    `warmup`).

    This is a run of the period, not a compile. The JAX dry run lowers
    the period onto the 16x16 mesh with the client axis over "data" and
    reads XLA's cost and memory analyses; eager PyTorch has no compiled
    program to analyse, and one card holds the whole federation (1,024
    clients of 1.64e6 bf16 parameters with f32 Adam moments are 17 GB),
    so the port runs it: every kernel of the path (batched LSH, the
    selection of `backend` and `tiling`, the exchange, flash attention
    in the exchange's forwards) at these shapes, the update through
    autograd. `flops` is counted apart from the timed run
    (`segment_flops`), the same on every device. Prints and returns the
    report (`run_fed_dryrun`)."""
    dr = prepare_fed_dryrun(num_clients, arch, backend, ref_mode, tiling,
                            reselect_every, attack, attack_frac,
                            attack_start, device=device, seed=seed)
    return run_fed_dryrun(dr, warmup=warmup, log=log)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "aecg", "seeg"])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true",
                    help="run one 256-client WPFed segment with reduced-"
                         "transformer clients (dryrun_fed_round)")
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
    if args.dryrun:
        sched = resolve_schedule(args.schedule, args.reselect_every)
        dryrun_fed_round(num_clients=args.clients or 256,
                         backend="kernel" if args.backend == "auto"
                         else args.backend,  # "ann" runs the ann path
                         ref_mode=args.ref_mode, tiling=args.tiling,
                         reselect_every=sched.reselect_every,
                         attack=args.attack, attack_frac=args.attack_frac,
                         attack_start=args.attack_start, device=args.device,
                         seed=args.seed)
        return
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

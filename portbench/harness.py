"""One run of one cell: set-up, the measured window, the traced stretch
and the check, through the port's normal path.

Set-up (timed as `setup_s`, from the process's start): the port's CUDA
kernels built or loaded (`repro_torch.kernels.build`, cached in
`build/repro_torch/` inside the checkout); data and weights made on the
device from the seed (`portbench.inputs`); the weights handed to
`core.protocol.init_state` through its `init_fn`, so that the round
state, the Adam state and the round-0 codes are the port's own; then
the first reselection periods (at least `check_rounds` rounds) run
through the same calls as the window, which is the warm-up of every
shape the window uses and the first stretch the reference replays.

The window runs `core/rounds.py:run_rounds` over
`core/protocol.py:wpfed_program` one reselection period at a time, as
`launch/fed.py:run_federation` builds it (`FedConfig` from the paper's
Table 1 values, `adam(lr)`, `recommended_dedupe(ref_mode)`, every
reselection published to a `core/chain.py:Blockchain` by
`launch/fed.py:chain_publisher`), until `seconds` have passed; round
indices continue across periods. The state before the window's last
period and after it is copied to the host outside the window's time,
for the reference to replay that period too. The chain is verified
after it.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import cells, check, faults, flops, inputs
from portbench.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole (`repro_torch` is not `repro`)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _quantile(values: List[float], q: float) -> float:
    """The q-quantile, linear between closest ranks."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Options:
    """What a run may change beyond the cell: the device (the CPU tests),
    traffic values (a smaller federation, the ANN route at 8 clients,
    fewer checked rounds), and the program as run (the lowered-precision
    control or a planted fault, for the calibration and the tests)."""
    device: str = "cuda"
    traffic: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tf32: bool = False             # the control (`faults.tf32_inputs`)
    wrap_program: Optional[Callable] = None


def _program_side(cfg: Dict, traffic: Dict, opts: Options):
    """Everything of the port a run touches, built as run_federation
    builds it."""
    from repro_torch.configs.paper_models import (PAPER_FED_OPTIMA,
                                                  ClientModelConfig,
                                                  FedConfig,
                                                  recommended_dedupe)
    from repro_torch.core import (init_state, resolve_schedule, run_rounds,
                                  wpfed_program)
    from repro_torch.core.chain import Blockchain
    from repro_torch.launch.fed import chain_publisher
    from repro_torch.models.client import apply_client_model, client_template
    from repro_torch.optim import adam

    model, proto = cfg["model"], cfg["protocol"]
    n_opt, alpha, gamma = PAPER_FED_OPTIMA[cfg["dataset"]]
    if (proto["num_neighbors"], proto["alpha"], proto["gamma"]) != \
            (n_opt, alpha, gamma):
        raise ValueError(f"{cfg['name']}: N, alpha, gamma differ from the "
                         f"paper's Table 1 ({n_opt}, {alpha}, {gamma})")
    backend = traffic["backend"]
    mcfg = ClientModelConfig(
        name=model["name"], kind=model["kind"],
        input_shape=tuple(model["input_shape"]),
        num_classes=model["num_classes"], hidden=tuple(model["hidden"]),
        kernel_size=model["kernel_size"])
    fed = FedConfig(
        num_clients=traffic["clients"], num_neighbors=n_opt, alpha=alpha,
        gamma=gamma, top_k=proto["top_k"], lsh_bits=proto["lsh_bits"],
        local_steps=proto["local_steps"], local_batch=proto["local_batch"],
        lr=proto["lr"], ref_batch=proto["ref_batch"],
        selection_backend=backend,
        exchange_backend="auto" if backend == "ann" else backend,
        ref_mode=traffic["ref_mode"], selection_tiling=traffic["tiling"],
        exchange_tiling=traffic["tiling"],
        dedupe_rankings=recommended_dedupe(traffic["ref_mode"]),
        ann_prefix_bits=proto["ann_prefix_bits"],
        ann_probes=proto["ann_probes"])
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    if opts.tf32:
        apply_fn = faults.tf32_inputs(apply_fn)
    opt = adam(fed.lr)
    program = wpfed_program(apply_fn, opt, fed)
    if opts.wrap_program is not None:
        program = opts.wrap_program(program)
    return SimpleNamespace(
        fed=fed, opt=opt, program=program, init_state=init_state,
        run_rounds=run_rounds, chain=Blockchain(),
        publisher=chain_publisher,
        schedule=resolve_schedule(traffic["schedule"],
                                  traffic["reselect_every"]
                                  if traffic["schedule"] == "gossip" else 0))


def _kernels():
    from repro_torch.kernels import (exchange, flash_attention, hamming,
                                     lsh_projection, selection)
    return {"lsh_projection": lsh_projection.KERNEL,
            "lsh_single": lsh_projection.SINGLE_KERNEL,
            "selection": selection.KERNEL,
            "selection_tiled": selection.TILED_KERNEL,
            "selection_ann": selection.ANN_KERNEL,
            "selection_ann_grouped": selection.GROUPED_KERNEL,
            "exchange": exchange.KERNEL,
            "exchange_streamed": exchange.STREAMED_KERNEL,
            "hamming": hamming.KERNEL,
            "flash_attention": flash_attention.KERNEL}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name()} (nvidia-smi: {e})"


def _to_host(tree) -> Dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in tree.items()}


def _snapshot(state) -> Dict[str, torch.Tensor]:
    return {"codes": state.codes.cpu(), "rankings": state.rankings.cpu(),
            "commitments": state.commitments.cpu()}


def _host_state(state) -> Dict[str, Any]:
    """What the check reads of a round state: parameters, Adam moments,
    codes, rankings, commitments, copied to the host."""
    return {"params": _to_host(state.params),
            "m": _to_host(state.opt_state["m"]),
            "v": _to_host(state.opt_state["v"]), **_snapshot(state)}


def _records(hist) -> List[Dict[str, Any]]:
    """The rounds of a period as the check reads them."""
    return [{"round": e["round"], "ids": e["neighbor_ids"],
             "valid": e["valid_mask"], "scores": e["ranking_scores"],
             "honest": e["honest_reporter_frac"],
             **{k: e[k] for k in ("mean_loss", "mean_ref_loss",
                                  "mean_neighbor_loss")}} for e in hist]


class Run:
    """One run: `setup`, `window`, `stretch`, `check`, in that order."""

    def __init__(self, cell: Dict, seed: int, seconds: float,
                 opts: Options = None, log: Callable = print,
                 t_start: float = None):
        self.cell, self.seed, self.seconds = cell, int(seed), seconds
        self.opts = opts or Options()
        self.log = log
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.cfg = cell["config_data"]
        self.traffic = {**cell["traffic_data"], **self.opts.traffic}
        self.dev = torch.device(self.opts.device)
        self.cuda = self.dev.type == "cuda"
        self.obs: Dict[str, Any] = {}
        self.round = 0
        self.window_rounds: List[float] = []

    def info(self, **kw) -> None:
        self.log(json.dumps({"info": kw}, default=str))

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.device import resolve_device
        resolve_device(self.dev)                 # TF32 off, the card asked
        if self.opts.tf32:                       # the program's own TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        if self.cuda:
            from repro_torch.kernels import build
            self.info(card=_card())
            t0 = time.perf_counter()
            built = build.build_all(_kernels().values())
            self.info(kernels_built=sorted(built),
                      build_s=time.perf_counter() - t0)
        cfg, traffic = self.cfg, self.traffic
        m = traffic["clients"]
        self.side = _program_side(cfg, traffic, self.opts)
        self.side.program = self._observed(self.side.program)
        self._observing = False
        self.data = inputs.make_data(cfg, m, self.seed, self.dev)
        weights = inputs.make_weights(cfg["model"], m, self.seed, self.dev)
        nxt = iter(range(m))

        def init_fn(_generator):
            i = next(nxt)
            return {k: v[i] for k, v in weights.items()}

        state = self.side.init_state(init_fn, self.side.opt, self.side.fed,
                                     self.seed)
        del weights
        opt = state.opt_state
        self.obs["init"] = {
            "fingerprint": {k: (float(v.to(torch.float64).sum()),
                                float(v.to(torch.float64).square().sum()))
                            for k, v in state.params.items()},
            "opt_abs": float(sum(t.abs().sum() for t in
                                 list(opt["m"].values())
                                 + list(opt["v"].values()))
                             + opt["step"].abs().sum()),
            **_snapshot(state)}
        g = self.side.schedule.reselect_every
        periods = -(-traffic["check_rounds"] // g)
        self.obs["rounds"], self.obs["states"] = [], []
        self._observing = True
        for _ in range(periods):
            state, hist = self._period(state)
            self.obs["rounds"] += _records(hist)
        self._observing = False
        self.state = state
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        self.setup_s = time.perf_counter() - self.t_start
        self.info(setup_s=self.setup_s, warmup_rounds=self.round,
                  warmup_round_s=self._warm_seconds)

    def _period(self, state):
        """One reselection period through run_rounds, published to the
        chain under its absolute round index."""
        g = self.side.schedule.reselect_every
        base = self.round
        pub = self.side.publisher(self.side.chain, self.side.fed.num_clients)

        def on_reselect(r0, st):
            with torch.profiler.record_function("portbench.publish"):
                pub(base + r0, st)

        t0 = time.perf_counter()
        state, hist = self.side.run_rounds(
            self.side.program, state, self.data, rounds=g,
            schedule=self.side.schedule, on_reselect=on_reselect)
        self._period_s = time.perf_counter() - t0
        for entry in hist:
            entry["round"] += base
        self._last_seconds = [h["seconds"] for h in hist]
        self._warm_seconds = getattr(self, "_warm_seconds", []) + \
            self._last_seconds
        self.round += g
        return state, hist

    def _observed(self, program):
        """The program with each round's new state copied to the host
        while set-up runs the rounds the check replays (a pass-through in
        the window)."""
        def wrap(round_fn):
            def call(state, *a, **k):
                out = round_fn(state, *a, **k)
                if self._observing:
                    self.obs["states"].append(_host_state(out[0]))
                return out
            return call
        return program._replace(
            global_round=wrap(program.global_round),
            gossip_round=wrap(program.gossip_round)
            if program.gossip_round else None)

    # -- the window -----------------------------------------------------------
    def window(self) -> None:
        """Periods until `seconds` have passed. Before each period that
        may be the last (when less than twice the longest period yet is
        left), the state is copied to the host, and after the last too, so
        that the check replays the window's last period; the copies' time
        is left out of the window's."""
        launches0 = self._launches()
        longest, held, before = self._period_s, 0.0, None
        unix0 = time.time()
        t0 = time.perf_counter()
        while True:
            if time.perf_counter() - t0 - held + 2 * longest >= self.seconds:
                t1 = time.perf_counter()
                before = _host_state(self.state)
                held += time.perf_counter() - t1
            r0 = self.round
            self.state, hist = self._period(self.state)
            longest = max(longest, self._period_s)
            self.window_rounds += self._last_seconds
            if time.perf_counter() - t0 - held >= self.seconds:
                break
            before = None
        self.window_s = time.perf_counter() - t0 - held
        launches = {k: v - launches0.get(k, 0)
                    for k, v in self._launches().items()}
        self.launches = {k: v for k, v in launches.items() if v}
        self.info(window_s=self.window_s, rounds=len(self.window_rounds),
                  round_seconds=self.window_rounds, window_unix=[
                      unix0, unix0 + time.perf_counter() - t0],
                  snapshot_s=held, kernel_launches=self.launches,
                  route=self.route())
        if before is None:
            # the last period outran the guess: check the next one instead
            r0, before = self.round, _host_state(self.state)
            self.state, hist = self._period(self.state)
            self.info(checked_period="the one after the window")
        self.obs["window"] = {"first_round": r0, "before": before,
                              "rounds": _records(hist),
                              "after": _host_state(self.state)}

    def _launches(self) -> Dict[str, int]:
        return {k: v.launches for k, v in _kernels().items()} \
            if self.cuda else {}

    def route(self) -> str:
        if not self.cuda:
            return "plain versions (CPU)"
        ann = self.launches.get("selection_ann_grouped", 0)
        exact = self.launches.get("selection", 0) + \
            self.launches.get("selection_tiled", 0)
        return "ann" if ann and not exact else "exact" if exact and not ann \
            else f"mixed (ann {ann}, exact {exact})"

    def end_to_end(self) -> Dict[str, Dict[str, Any]]:
        rounds = len(self.window_rounds)
        out = {"round_s": {"value": self.window_s / rounds, "unit": "s"},
               "round_p90_s": {"value": _quantile(self.window_rounds, 0.9),
                               "unit": "s"},
               "peak_mem_gb": {"value": self.peak_bytes / 1e9, "unit": "GB"},
               "setup_s": {"value": self.setup_s, "unit": "s"}}
        return out

    # -- the traced stretch ---------------------------------------------------
    def stretch(self) -> Dict[str, Any]:
        """Whole periods covering `trace_rounds` rounds under the profiler;
        the per-layer metrics and the breakdown from its trace."""
        from torch.profiler import ProfilerActivity, profile, record_function
        g = self.side.schedule.reselect_every
        periods = max(1, -(-self.traffic["trace_rounds"] // g))
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("portbench.stretch"):
                for _ in range(periods):
                    self.state, _ = self._period(self.state)
                if self.cuda:
                    torch.cuda.synchronize(self.dev)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = Trace.load(path)
        finally:
            os.remove(path)
        ctx = SimpleNamespace(
            trace=tr, rounds=periods * g, global_rounds=periods,
            round_s=self.window_s / len(self.window_rounds),
            flops_per_round=self.cell["cell_data"].get(
                "flops", {}).get("total"),
            announce_least_s=flops.announce_least_s(self.cfg, self.traffic),
            peaks=flops.PEAKS)
        values = {}
        for name, spec in self.cell["per_layer"].items():
            v = cells.metric_reader(name, self.cell["base"])(ctx)
            if v is not None:
                values[name] = {"value": v, "unit": spec["unit"]}
        self.info(traced_rounds=ctx.rounds, traced_global_rounds=periods,
                  device_us_by_phase=tr.by_phase(),
                  device_events=len(tr.in_stretch()),
                  unlaunched_events=sum(1 for e in tr.in_stretch()
                                        if tr.phase_of(e[3]) ==
                                        "unlaunched"))
        busy = tr.busy_us() / 1e6 if tr.stretch else 0.0
        return {"metrics": values, "busy_s": busy,
                "window_s": tr.wall_us() / 1e6 if tr.stretch else 0.0,
                "breakdown": {"device_ops": tr.top_ops(),
                              "idle_gaps": tr.idle_gaps()}}

    # -- the check ------------------------------------------------------------
    def finish_program(self) -> None:
        """Read the peak, verify the chain, keep what the check reads,
        free the program's state."""
        self.peak_bytes = torch.cuda.max_memory_allocated(self.dev) \
            if self.cuda else 0
        chain = self.side.chain
        self.obs["chain_verified"] = bool(chain.verify_chain())
        self.obs["chain"] = [{"index": b.index, "prev_hash": b.prev_hash,
                              "payload": b.payload,
                              "timestamp": b.timestamp, "hash": b.hash}
                             for b in chain.blocks]
        g = self.side.schedule.reselect_every
        self.obs["chain_rounds"] = list(range(1, self.round + 1, g))
        self.obs["final"] = _snapshot(self.state)
        del self.state, self.data, self.side
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, Dict[str, float]]:
        limits = self.cell["cell_data"].get("limits", {})
        limits = {k: limits.get(k, 0.0) for k in check.GAPS}
        t0 = time.perf_counter()
        out = check.run_check(self.cfg, self.traffic, self.seed, self.obs,
                              limits, self.dev,
                              log=lambda s: self.info(check=s))
        self.info(check_s=time.perf_counter() - t0)
        return out


def device_record(run: Run, extra: Dict = None) -> Dict[str, Any]:
    if run.cuda:
        kind = torch.cuda.get_device_name(run.dev)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    rec = {"platform": platform, "kind": kind, "count": 1,
           "memory_peak_bytes": int(run.peak_bytes)}
    rec.update(extra or {})
    return rec


def execute(cell: Dict, seed: int, seconds: float, trace: bool,
            opts: Options = None, log: Callable = print,
            t_start: float = None) -> Dict[str, Any]:
    """A whole run; returns the result line's object."""
    run = Run(cell, seed, seconds, opts, log=log, t_start=t_start)
    run.setup()
    run.window()
    traced = run.stretch() if trace else None
    run.finish_program()
    checks = run.check()
    failed = [k for k, v in checks.items() if not v["value"] <= v["limit"]]
    if trace:
        metrics = traced["metrics"]
        dev = device_record(run, {"busy_s": traced["busy_s"],
                                  "window_s": traced["window_s"]})
    else:
        e2e = run.end_to_end()
        metrics = {k: e2e[k] for k in cell["end_to_end"] if k in e2e}
        dev = device_record(run)
    result = {"correct": not failed, "attempted": len(run.window_rounds),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {k: [v["value"], v["limit"]] for k, v in checks.items()}
    return result

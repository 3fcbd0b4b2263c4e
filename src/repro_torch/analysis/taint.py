"""The privacy-taint check as a dataflow over the ops a target runs.
Counterpart of `repro/analysis/taint.py`.

Private sources (a client's parameters, its optimizer state, its local
batches) are labelled at the arguments of each analysis target; labels
follow the values through every op the target runs, and only the
registered `@declassifier` functions (`repro_torch.analysis.privacy`)
clear them. A labelled value reaching a declared `sink(...)` is a
`taint-sink` finding; a labelled value read to the host (`item`,
`tolist`, `numpy`, `int`/`float`/`bool`/`index` of a tensor, `cpu`,
`to("cpu")`, a Python `if` on one) is a `taint-host-read` finding, the
port's counterpart of `taint-callback`: in eager PyTorch a value leaves
the device by a host read, not a callback. A target that raises, or
whose label tree does not mirror its arguments, is a
`taint-trace-error`. Findings name the file and line of the sink call or
host read in the code under check, never a frame of `analysis/` or of
torch.

The engine:

  * Propagation runs in a `TorchDispatchMode`, which sees every aten op
    with its inputs and outputs, in the forward and in the backward (the
    vmapped `torch.func.grad_and_value` of `protocol.
    batched_local_update`), under `torch.func.vmap` and
    `functional_call`. Labels are keyed on a
    tensor's storage (device, storage pointer), so a write through a
    view taints its base; a weak reference to the storage tells a live
    key from an address the allocator has handed out again. An op's
    output on a storage none of its inputs holds is fresh and gets the
    union of its inputs' labels (set, never added to an old label of a
    reused address); an output that aliases an input, and every argument
    the op's schema writes (`alias_info.is_write`: in-place ops, `out=`,
    the optimizer's `add_`/`mul_` under `no_grad`), gets the union added.
  * The CUDA kernels launch through ctypes, so the dispatch mode sees
    only the `empty` that allocated their outputs. While the check runs,
    each wrapper registered with `registry.kernel_contract` gives its
    outputs the union of its tensor inputs' labels (`kernel_value`), the
    rule the JAX engine applies to `pallas_call`. Without it every
    target on the card would pass vacuously. Flash attention reaches its
    kernel through a custom op (`repro_torch::gqa_attention`, for its
    vmap rule), which the dispatch mode does see: once per call, on the
    folded batch, its output fresh with the union of the inputs' labels.
    The wrapper rule then adds that same union, so the two agree and a
    label is never counted twice (`tests/test_torch_client_axis.py`).
  * Host reads are seen by a `TorchFunctionMode` (the dispatch mode does
    not see `tolist` of a CPU tensor); the dispatch mode adds the ones
    that reach `_local_scalar_dense` or copy device memory to the host
    without a Python method.

What this proves, next to the jaxpr engine: it checks the path that
ran. The jaxpr engine unions both branches of every `lax.cond`
(`repro/analysis/taint.py:_eval_cond`) and fixpoints scan and while
carries; here a branch taken on public values (a round index, a config
flag) is checked only as far as the targets drive it, and the other
branch not at all. A branch on a private value is a Python `bool` of a
tensor, so it is flagged as a host read rather than followed. Data the
targets do not reach (other federation sizes, the ANN route, attacks
other than `lsh_cheat`) is unchecked.

Analysis targets are the protocol's real entry points over a tiny
4-client federation (`_tiny`): every WPFed phase, the wpfed and baseline
round programs, a metrics-tapped segment, the adversary-instrumented
segment, the service's global, tapped and degraded rounds and the
serving forward, the JAX package's 16 head targets by name. On the CPU
they run the plain versions; on the card the kernel backends, through
the wrapper rule. Fixtures register their own targets with
`taint_target(...)`, captured in isolation by `capture_targets`.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import privacy
from repro_torch.analysis.report import Finding
from repro_torch.tree import tree_leaves, tree_map

# the private-source labels, the JAX package's
SRC_PARAMS = "client-params"
SRC_OPT = "opt-state"
SRC_DATA = "client-data"
SOURCES = (SRC_PARAMS, SRC_OPT, SRC_DATA)

EMPTY: frozenset = frozenset()

# tensor methods and torch functions that hand a tensor's value to Python
_HOST_METHODS = frozenset((
    "item", "tolist", "numpy", "cpu", "__int__", "__float__", "__bool__",
    "__index__", "__complex__", "__array__", "__repr__", "__format__",
    "__contains__", "equal", "allclose", "is_nonzero"))

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep

# the engine of the target being checked (kernel wrappers, declassifiers
# and sinks reach it through here)
_CURRENT: List[Optional["Engine"]] = [None]


def _fmt(labels: frozenset) -> str:
    return "{" + ", ".join(sorted(labels)) + "}"


def _rel(path: str) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def _caller() -> Tuple[str, int]:
    """(file, line) of the innermost frame outside torch and outside
    this package: the code under check that made the call."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not (path.startswith(_TORCH_DIR) or path.startswith(_ANALYSIS_DIR)
                or frame.f_code.co_filename.startswith("<")):
            return _rel(path), frame.f_lineno
        frame = frame.f_back
    return "<taint>", 0


def _tensors(value) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts, lists, tuples and named tuples
    (the protocol's trees and an op's arguments alike)."""
    return [t for t in tree_leaves(value) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    """The storage behind `t` (a functorch wrapper's inner tensor's), or
    None for a tensor without bytes."""
    try:
        from torch._C import _functorch
        while _functorch.is_functorch_wrapped_tensor(t):
            t = _functorch.get_unwrapped(t)
        st = t.untyped_storage()
        if st.nbytes() == 0:
            return None
        return (t.device.type, t.device.index, st.data_ptr()), st
    except (RuntimeError, NotImplementedError, AttributeError):
        return None


class Engine:
    """The labels of one target's run and the findings it produced."""

    def __init__(self, target: str):
        self.target = target
        self.findings: List[Finding] = []
        self.kernels: Set[str] = set()     # wrappers whose rule fired
        self.host_depth = 0                # inside a method-level host read
        self._labels: Dict[tuple, Tuple[frozenset, weakref.ref]] = {}

    def labels(self, t: torch.Tensor) -> frozenset:
        got = _storage(t)
        if got is None:
            return EMPTY
        key, st = got
        entry = self._labels.get(key)
        if entry is None:
            return EMPTY
        if entry[1]() is not st:          # the address was reused
            del self._labels[key]
            return EMPTY
        return entry[0]

    def of(self, value) -> frozenset:
        """The union of the labels of every tensor leaf of `value`."""
        out = EMPTY
        for t in _tensors(value):
            out = out | self.labels(t)
        return out

    def set(self, t: torch.Tensor, labels: frozenset) -> None:
        got = _storage(t)
        if got is not None:
            self._labels[got[0]] = (frozenset(labels), weakref.ref(got[1]))

    def add(self, t: torch.Tensor, labels: frozenset) -> None:
        if labels:
            self.set(t, self.labels(t) | labels)

    def report(self, rule: str, message: str) -> None:
        path, line = _caller()
        self.findings.append(Finding(rule, path, line,
                                     f"{self.target}: {message}"))


def _schema_writes(func, args, kwargs):
    """The argument values an op's schema marks as written."""
    try:
        schema = func._schema
    except AttributeError:
        return []
    out, pos = [], 0
    for a in schema.arguments:
        if a.kwarg_only:
            value = kwargs.get(a.name)
        else:
            value = args[pos] if pos < len(args) else kwargs.get(a.name)
            pos += 1
        if a.alias_info is not None and a.alias_info.is_write:
            out.append(value)
    return out


def _host_copy(func, args, kwargs) -> bool:
    """A copy of device memory to the host made below the Python methods
    (`.to("cpu")` reaches `_to_copy`; `cpu_tensor.copy_(cuda_tensor)`)."""
    name = getattr(func, "__name__", "")
    if name.startswith("_to_copy"):
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev).type == "cpu" and \
            isinstance(args[0], torch.Tensor) and args[0].device.type != "cpu"
    if name.startswith("copy_"):
        return (len(args) > 1 and isinstance(args[1], torch.Tensor)
                and args[0].device.type == "cpu"
                and args[1].device.type != "cpu")
    return False


class _Propagate(TorchDispatchMode):
    """Labels through every aten op (see the module docstring)."""

    def __init__(self, engine: Engine):
        super().__init__()
        self.engine = engine

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        e = self.engine
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        union = EMPTY
        for t in ins:
            union = union | e.labels(t)
        if union and e.host_depth == 0 and (
                func is torch.ops.aten._local_scalar_dense.default
                or _host_copy(func, args, kwargs)):
            e.report("taint-host-read",
                     f"{func} of a value tainted by {_fmt(union)} reads it "
                     f"to the host undeclassified")
        out = func(*args, **kwargs)
        in_keys = {got[0] for got in map(_storage, ins) if got is not None}
        for value in _schema_writes(func, args, kwargs):
            for t in _tensors(value):
                e.add(t, union)
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            got = _storage(t)
            if got is None:
                continue
            if got[0] in in_keys:
                e.add(t, union)
            else:
                e.set(t, union)
        return out


def _to_cpu(args, kwargs) -> bool:
    """Does a `Tensor.to(...)` call move its tensor to the host?"""
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, (str, torch.device)):
            try:
                if torch.device(a).type == "cpu":
                    return True
            except RuntimeError:
                continue
        elif isinstance(a, torch.Tensor) and a.device.type == "cpu":
            return True
    return False


class _HostReads(TorchFunctionMode):
    """Host reads at the Python surface (see the module docstring)."""

    def __init__(self, engine: Engine):
        super().__init__()
        self.engine = engine

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _HOST_METHODS:
            op = name
        elif name == "to" and _to_cpu(args, kwargs):
            op = 'to("cpu")'
        else:
            return func(*args, **kwargs)
        e = self.engine
        labels = e.of((args, kwargs))
        if labels:
            e.report("taint-host-read",
                     f"{op} of a value tainted by {_fmt(labels)} reads it "
                     f"to the host undeclassified")
        e.host_depth += 1
        try:
            return func(*args, **kwargs)
        finally:
            e.host_depth -= 1


# ---------------------------------------------------------------------------
# the markers' hooks (privacy.declassifier / privacy.sink /
# registry.kernel_contract call these while the check runs)
# ---------------------------------------------------------------------------
def declassify_value(value, name: str):
    """Each tensor leaf of `value` as a fresh clone without labels."""
    e = _CURRENT[0]

    def clear(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf.clone()
        if e is not None:
            e.set(out, EMPTY)
        return out

    return tree_map(clear, value)


def sink_value(value, name: str) -> None:
    """A `taint-sink` finding per labelled tensor leaf of `value`."""
    e = _CURRENT[0]
    if e is None:
        return
    for t in _tensors(value):
        labels = e.labels(t)
        if labels:
            e.report("taint-sink",
                     f"sink {name!r} receives a value tainted by "
                     f"{_fmt(labels)} with no declassifier on the path")


def kernel_value(out, inputs, name: str):
    """The wrapper rule: every tensor output of a registered kernel
    wrapper gets the union of its tensor inputs' labels."""
    e = _CURRENT[0]
    if e is not None:
        e.kernels.add(name)
        union = e.of(inputs)
        for t in _tensors(out):
            e.add(t, union)
    return out


# ---------------------------------------------------------------------------
# analysis targets
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TaintTarget:
    """One entry point to check. `build()` -> (fn, args, labels): `fn` is
    called as fn(*args); `labels` mirrors the tree of `args` (the
    `repro_torch.tree` leaf order) with a source label per leaf ("" =
    untainted); build label trees with `tree_map` over the args so the
    leaves line up."""
    name: str
    build: Callable


# name -> target; filled by fixture modules at import time
TARGETS: Dict[str, TaintTarget] = {}


def taint_target(*, name: str, build: Callable) -> TaintTarget:
    """Register an analysis target (the fixture modules' hook)."""
    t = TaintTarget(name=name, build=build)
    TARGETS[name] = t
    return t


class capture_targets:
    """Context manager: record targets registered while active (fixture
    modules checked in isolation from head_targets)."""

    def __enter__(self) -> List[TaintTarget]:
        self._before = set(TARGETS)
        self._new: List[TaintTarget] = []
        return self._new

    def __exit__(self, *exc):
        for k in set(TARGETS) - self._before:
            self._new.append(TARGETS.pop(k))
        return False


@dataclasses.dataclass
class Run:
    """One target's run: its findings, its engine (`engine.of(value)`
    gives a value's labels) and fn's output (None if it raised)."""
    findings: List[Finding]
    engine: Engine
    out: Any = None


def run_labelled(name: str, fn: Callable, args: tuple, labels) -> Run:
    """Run fn(*args) under the check with `labels` on the args."""
    engine = Engine(name)
    arg_leaves, label_leaves = tree_leaves(args), tree_leaves(labels)
    if len(arg_leaves) != len(label_leaves):
        return Run([Finding(
            "taint-trace-error", "<taint>", 0,
            f"{name}: {len(label_leaves)} source labels for "
            f"{len(arg_leaves)} argument leaves — the label tree must "
            f"mirror the args tree")], engine)
    for leaf, lab in zip(arg_leaves, label_leaves):
        if not lab:
            continue
        if not isinstance(leaf, torch.Tensor):
            return Run([Finding(
                "taint-trace-error", "<taint>", 0,
                f"{name}: label {lab!r} on a {type(leaf).__name__} leaf; "
                f"only tensors carry labels")], engine)
        engine.add(leaf, frozenset([lab]))
    prev = _CURRENT[0]
    _CURRENT[0] = engine
    try:
        with privacy.tracing(), _HostReads(engine), _Propagate(engine):
            out = fn(*args)
    except Exception as e:  # noqa: BLE001 — any failure is a finding
        return Run(engine.findings + [Finding(
            "taint-trace-error", "<taint>", 0,
            f"{name}: {type(e).__name__}: {e}")], engine)
    finally:
        _CURRENT[0] = prev
    return Run(list(engine.findings), engine, out)


def run_target(target: TaintTarget, device=None) -> Run:
    """Build and run one target; `device` moves its tensor arguments
    there first (fixtures build theirs on the CPU)."""
    try:
        fn, args, labels = target.build()
        if device is not None:
            args = tree_map(lambda t: t.to(device)
                            if isinstance(t, torch.Tensor) else t, args)
    except Exception as e:  # noqa: BLE001
        return Run([Finding("taint-trace-error", "<taint>", 0,
                            f"{target.name}: {type(e).__name__}: {e}")],
                   Engine(target.name))
    return run_labelled(target.name, fn, args, labels)


def check_target(target: TaintTarget, device=None) -> List[Finding]:
    return run_target(target, device).findings


def check_targets(targets=None, device: str = "cpu") -> List[Finding]:
    """The findings of `targets` (default: the head targets) on
    `device`."""
    targets = head_targets(device) if targets is None else targets
    out: List[Finding] = []
    for t in targets:
        out.extend(check_target(t, device))
    return out


# ---------------------------------------------------------------------------
# HEAD targets: the protocol surface over a tiny federation
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=2)
def _tiny(device: str = "cpu"):
    """The JAX package's `_tiny`: 4 MLP clients (d 8, hidden 8, 3
    classes), N 2, top_k 1, one local step of batch 4, 32-bit codes,
    zero data; the plain versions on the CPU, the kernels on the card."""
    from repro_torch.configs.paper_models import (ClientModelConfig,
                                                  FedConfig)
    from repro_torch.core import protocol
    from repro_torch.models.client import (apply_client_model,
                                           client_template,
                                           init_client_model)
    from repro_torch.optim import adam

    dev = torch.device(device)
    m, d, classes, n_loc, n_ref = 4, 8, 3, 8, 4
    backend = "oracle" if dev.type == "cpu" else "kernel"
    mcfg = ClientModelConfig("taint-mlp", "mlp", (d,), classes, hidden=(8,))
    fed = FedConfig(num_clients=m, num_neighbors=2, top_k=1, local_steps=1,
                    local_batch=4, lsh_bits=32, lr=1e-2,
                    selection_backend=backend, exchange_backend=backend)
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))

    def init_fn(g):
        return init_client_model(mcfg, g, device=dev)

    opt = adam(fed.lr)
    state = protocol.init_state(init_fn, opt, fed, seed=0)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    data = {"x_train": zeros(m, n_loc, d),
            "y_train": zeros(m, n_loc, dtype=torch.int32),
            "x_ref": zeros(m, n_ref, d),
            "y_ref": zeros(m, n_ref, dtype=torch.int32),
            "x_test": zeros(m, n_loc, d),
            "y_test": zeros(m, n_loc, dtype=torch.int32)}
    return {"fed": fed, "apply_fn": apply_fn, "init_fn": init_fn,
            "opt": opt, "state": state, "data": data, "m": m, "d": d,
            "device": dev}


def _fed_labels(state):
    """FedState label tree: params and opt_state private; the published
    fields (last round's declassified announcements), seed and round
    untainted."""
    lab = tree_map(lambda _: "", state)
    return lab._replace(
        params=tree_map(lambda _: SRC_PARAMS, state.params),
        opt_state=tree_map(lambda _: SRC_OPT, state.opt_state))


def _data_labels(data):
    return tree_map(lambda _: SRC_DATA, data)


def _head_target_builders(device: str = "cpu"):
    """name -> build() pairs, the JAX package's `_head_target_builders`
    one for one."""
    t = _tiny(device)
    fed, apply_fn, opt = t["fed"], t["apply_fn"], t["opt"]
    state, data, dev = t["state"], t["data"], t["device"]

    from repro_torch.core import adversary, baselines, protocol
    from repro_torch.core.rounds import make_segment_fn
    from repro_torch.service import driver as svc_driver
    from repro_torch.service.membership import (ServiceConfig,
                                                init_service_state,
                                                mask_stragglers)
    from repro_torch.service.serving import PersonalizedServer

    sd = (state, data)
    sd_labels = (_fed_labels(state), _data_labels(data))

    def _phase_select():
        return (lambda st: protocol.select_phase(st, fed),
                (state,), (_fed_labels(state),))

    def _phase_exchange():
        def fn(st, d):
            sel = protocol.select_phase(st, fed)
            return protocol.exchange_phase(apply_fn, fed, st.params, d, sel)
        return fn, sd, sd_labels

    def _phase_update():
        def fn(st, d):
            sel = protocol.select_phase(st, fed)
            exch = protocol.exchange_phase(apply_fn, fed, st.params, d, sel)
            return protocol.update_phase(
                apply_fn, opt, fed, st.params, st.opt_state, d, exch,
                protocol.round_generator(st.seed, st.round,
                                         protocol.UPDATE_STREAM))
        return fn, sd, sd_labels

    def _phase_announce():
        def fn(st, d):
            sel = protocol.select_phase(st, fed)
            exch = protocol.exchange_phase(apply_fn, fed, st.params, d, sel)
            return protocol.announce_phase(fed, st.params, sel, exch,
                                           st.round)
        return fn, sd, sd_labels

    wpfed = protocol.wpfed_program(apply_fn, opt, fed)

    def _wpfed_global():
        return wpfed.global_round, sd, sd_labels

    def _wpfed_gossip():
        def fn(st, d):
            sel = protocol.select_phase(st, fed)
            return wpfed.gossip_round(st, d, sel)
        return fn, sd, sd_labels

    def _wpfed_segment_tap():
        seg = make_segment_fn(wpfed, 3, metrics_tap=lambda s: None)
        return seg, sd, sd_labels

    def _instrumented_global():
        tm = adversary.resolve_threat(
            "lsh_cheat", num_clients=t["m"], attacker_frac=0.25,
            init_fn=t["init_fn"], start_round=0, target_id=0)
        inst = adversary.instrument_program(wpfed, tm)
        seg = make_segment_fn(inst, 2, metrics_tap=lambda s: None)
        return seg, sd, sd_labels

    def _baseline(name):
        def build():
            kwargs = {}
            if name == "fedmd":
                kwargs["shared_ref_x"] = torch.zeros(
                    data["x_ref"].shape[1:], dtype=data["x_ref"].dtype,
                    device=dev)
            prog = baselines.BASELINE_PROGRAMS[name](apply_fn, opt, fed,
                                                     **kwargs)
            return prog.global_round, sd, sd_labels
        return build

    svc = ServiceConfig(reselect_every=2)
    svc_prog = svc_driver.service_program(apply_fn, opt, fed, svc)
    svc_state = init_service_state(state, svc)
    ssd = (svc_state, data)
    ssd_labels = (svc_state._replace(
        fed=_fed_labels(state), active="", code_age="", gossip_count="",
        period_start=""), _data_labels(data))

    def _service_global():
        return svc_prog.global_round, ssd, ssd_labels

    def _service_segment_tap():
        seg = make_segment_fn(svc_prog, 2, metrics_tap=lambda s: None)
        return seg, ssd, ssd_labels

    def _service_degraded():
        # a degraded round: a straggler masked inactive mid-service and
        # stale re-joiners with nonzero code_age; the boundary must hold
        # on the faulted path too
        degraded = mask_stragglers(
            svc_state._replace(code_age=torch.arange(
                t["m"], dtype=torch.int32, device=dev)),
            torch.arange(t["m"]) == 1)
        return svc_prog.global_round, (degraded, data), ssd_labels

    def _serving_forward():
        ids = torch.zeros((2,), dtype=torch.int64, device=dev)
        x = torch.zeros((2, t["d"]), dtype=torch.float32, device=dev)

        def fn(ps, ids, x):
            return PersonalizedServer(apply_fn, ps)._forward(ids, x)

        return (fn, (state.params, ids, x),
                (tree_map(lambda _: SRC_PARAMS, state.params), "", ""))

    return [
        ("phase-select", _phase_select),
        ("phase-exchange", _phase_exchange),
        ("phase-update", _phase_update),
        ("phase-announce", _phase_announce),
        ("wpfed-global-round", _wpfed_global),
        ("wpfed-gossip-round", _wpfed_gossip),
        ("wpfed-segment-tapped", _wpfed_segment_tap),
        ("wpfed-instrumented-segment", _instrumented_global),
        ("baseline-silo", _baseline("silo")),
        ("baseline-fedmd", _baseline("fedmd")),
        ("baseline-proxyfl", _baseline("proxyfl")),
        ("baseline-kdpdfl", _baseline("kdpdfl")),
        ("service-global-round", _service_global),
        ("service-segment-tapped", _service_segment_tap),
        ("service-degraded-round", _service_degraded),
        ("serving-forward", _serving_forward),
    ]


def head_targets(device: str = "cpu") -> List[TaintTarget]:
    return [TaintTarget(name=name, build=build)
            for name, build in _head_target_builders(device)]

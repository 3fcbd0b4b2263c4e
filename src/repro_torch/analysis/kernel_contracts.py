"""Contract checks of the hand-written CUDA kernels.
Counterpart of `repro/analysis/kernel_contracts.py`.

For every entry of `registry.REGISTRY`:

  * `oracle-missing`: the declared twin is not in `kernels/ref.py`;
  * `symbol-missing`: the entry's launch symbol is not exported by its
    source; `estimator-missing`: a declared C helper is not exported, or
    an estimator names a helper the entry does not declare (the sources
    are read as text, so this runs without a compiler);
  * completeness (`unregistered-kernel`): every `extern "C"` symbol of
    `kernels/csrc/*.cu` is some entry's launch symbol or declared helper,
    and every `CudaKernel` has an entry: the `CudaKernel(...)` call sites
    of each file under `src/repro_torch` count the entries of its
    wrappers, and every `CudaKernel` object in a kernel module is one an
    entry holds;
  * on the card only, `estimator-drift`: each Python shared-memory
    function and its C mirror, evaluated at the entry's points, are equal
    (the counterpart of the JAX VMEM-estimator check); and the contract
    launch (`contract-launch`): each entry launched once at
    `points[0]`, held against its twin on the same device at its
    declared class.

The JAX checker's BlockSpec checks (output-tile coverage, write races,
out-of-bounds tiles, block and kernel-body arity) have no CUDA form: a
CUDA kernel computes its own indices, so nothing declarative describes
its tiling. What stands in for them is the launch against the twin at
the representative shape here and the shapes `chip_smoke.py` and
`tests/test_torch_cuda.py` hold every kernel at.
"""
from __future__ import annotations

import ast
import ctypes
import importlib
import os
import re
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.analysis.registry import REGISTRY, KernelEntry
from repro_torch.analysis.report import Finding
from repro_torch.tree import tree_leaves, tree_map

# kernel modules whose import fills REGISTRY
KERNEL_MODULES = (
    "repro_torch.kernels.lsh_projection",
    "repro_torch.kernels.hamming",
    "repro_torch.kernels.selection",
    "repro_torch.kernels.exchange",
    "repro_torch.kernels.flash_attention",
)
PORT_ROOT = Path(__file__).resolve().parents[1]         # src/repro_torch
CSRC = PORT_ROOT / "kernels" / "csrc"

_EXTERN = re.compile(r'extern\s+"C"\s+[^;{(]*?\b(\w+)\s*\(')


def head_entries() -> List[KernelEntry]:
    for mod in KERNEL_MODULES:
        importlib.import_module(mod)
    return [REGISTRY[k] for k in sorted(REGISTRY)]


def _rel(path) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return str(path)
    return str(path) if rel.startswith("..") else rel


def entry_loc(entry: KernelEntry) -> Tuple[str, int]:
    code = entry.fn.__code__
    return _rel(code.co_filename), code.co_firstlineno


def exported_symbols(path) -> Dict[str, int]:
    """{symbol: line} of the `extern "C"` functions of a CUDA source."""
    try:
        text = Path(path).read_text(encoding="utf-8")
    except OSError:
        return {}
    return {m.group(1): text.count("\n", 0, m.start()) + 1
            for m in _EXTERN.finditer(text)}


def check_entry(entry: KernelEntry) -> List[Finding]:
    """The static checks of one entry (no device, no compiler)."""
    from repro_torch.kernels import ref
    path, line = entry_loc(entry)
    out: List[Finding] = []
    if not hasattr(ref, entry.twin):
        out.append(Finding("oracle-missing", path, line,
                           f"{entry.name}: twin {entry.twin!r} not found in "
                           f"kernels/ref.py"))
    source = entry.kernel.source
    exported = exported_symbols(source)
    if entry.kernel.symbol not in exported:
        out.append(Finding("symbol-missing", path, line,
                           f"{entry.name}: {source.name} exports no "
                           f"{entry.kernel.symbol!r}"))
    for h in entry.helpers:
        if h not in exported:
            out.append(Finding("estimator-missing", path, line,
                               f"{entry.name}: declared helper {h!r} is not "
                               f"exported by {source.name}"))
    for est in entry.estimators:
        if est.symbol not in entry.helpers:
            out.append(Finding("estimator-missing", path, line,
                               f"{entry.name}: estimator {est.symbol!r} is "
                               f"not a declared helper"))
    return out


def check_entries(entries=None) -> List[Finding]:
    entries = head_entries() if entries is None else entries
    out: List[Finding] = []
    for entry in entries:
        out.extend(check_entry(entry))
    return out


# ---------------------------------------------------------------------------
# completeness
# ---------------------------------------------------------------------------
def cuda_kernel_lines(path) -> List[int]:
    """Lines of `CudaKernel(...)` call expressions in a Python file (AST
    calls only: the class definition, imports and prose do not count)."""
    try:
        tree = ast.parse(Path(path).read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return []
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if name == "CudaKernel":
                lines.append(node.lineno)
    return sorted(lines)


def _module_file(entry: KernelEntry) -> str:
    """The file that defines the entry's wrapper (and its kernel)."""
    return os.path.realpath(entry.fn.__code__.co_filename)


def _kernels_by_file(entries) -> Dict[str, set]:
    out: Dict[str, set] = {}
    for e in entries:
        out.setdefault(_module_file(e), set()).add(id(e.kernel))
    return out


def completeness_file_findings(path, entries,
                               module=None) -> List[Finding]:
    """One Python file: its CudaKernel call sites against the kernels its
    entries hold, and (given its module) every CudaKernel object in it.
    The CLI's path mode checks a fixture file alone with it."""
    from repro_torch.kernels.build import CudaKernel
    lines = cuda_kernel_lines(path)
    held = _kernels_by_file(entries).get(os.path.realpath(path), set())
    if len(lines) != len(held):
        return [Finding(
            "unregistered-kernel", _rel(path), lines[0] if lines else 1,
            f"{len(lines)} CudaKernel(...) site(s) at lines {lines} but "
            f"the registered entries of this module hold {len(held)} — "
            f"every kernel needs a kernel_contract entry")]
    out = []
    for name, obj in sorted(vars(module).items() if module else ()):
        if isinstance(obj, CudaKernel) and id(obj) not in held:
            out.append(Finding(
                "unregistered-kernel", _rel(path), 1,
                f"CudaKernel {obj.name!r} ({name}) has no kernel_contract "
                f"entry"))
    return out


def completeness_findings(entries=None, port_root=None,
                          csrc=None) -> List[Finding]:
    """Every exported C symbol under kernels/csrc is registered, and every
    CudaKernel under src/repro_torch has an entry."""
    entries = head_entries() if entries is None else entries
    port_root = Path(port_root or PORT_ROOT)
    csrc = Path(csrc or CSRC)
    declared: Dict[str, set] = {}
    for e in entries:
        declared.setdefault(e.kernel.source.name, set()).update(
            (e.kernel.symbol, *e.helpers))
    out: List[Finding] = []
    for cu in sorted(csrc.glob("*.cu")):
        known = declared.get(cu.name, set())
        for sym, line in sorted(exported_symbols(cu).items()):
            if sym not in known:
                out.append(Finding(
                    "unregistered-kernel", _rel(cu), line,
                    f"extern \"C\" {sym} is neither an entry's launch "
                    f"symbol nor a declared helper"))
    modules = {os.path.realpath(getattr(sys.modules.get(m), "__file__", "")
                                or ""): sys.modules.get(m)
               for m in KERNEL_MODULES}
    for root, dirs, files in os.walk(port_root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                out.extend(completeness_file_findings(
                    path, entries, modules.get(os.path.realpath(path))))
    return out


# ---------------------------------------------------------------------------
# on the card: estimator drift and the contract launch
# ---------------------------------------------------------------------------
def estimator_findings(entries=None) -> Tuple[List[Finding], int]:
    """(findings, comparisons): every estimator against its C mirror at
    every point of its entry. Builds the libraries (needs nvcc)."""
    entries = head_entries() if entries is None else entries
    out, n = [], 0
    for e in entries:
        for est in e.estimators:
            mirror = e.kernel.helper(est.symbol, [ctypes.c_int] * len(
                est.args(e.points[0])[0]))
            for point in e.points:
                for args in est.args(point):
                    n += 1
                    py, c = int(est.fn(*args)), int(mirror(*map(int, args)))
                    if py != c:
                        out.append(Finding(
                            "estimator-drift", *entry_loc(e),
                            f"{e.name}: {est.fn.__name__}{tuple(args)} = "
                            f"{py} but the C {est.symbol} says {c} "
                            f"(at {point})"))
    return out, n


def _to(value, device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, value)


def compare(entry: KernelEntry, got, want) -> Tuple[bool, float]:
    """(agrees at the entry's class, max abs error of the float outputs
    over finite entries)."""
    got = [t for t in tree_leaves(got) if isinstance(t, torch.Tensor)]
    want = [t for t in tree_leaves(want) if isinstance(t, torch.Tensor)]
    if len(got) != len(want):
        return False, float("inf")
    ok, err = True, 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        if not a.is_floating_point():
            ok = ok and torch.equal(a, b)
            continue
        fin = torch.isfinite(a) & torch.isfinite(b)
        if fin.any():
            err = max(err, (a[fin].double() - b[fin].double()).abs().max()
                      .item())
        if entry.exactness == "exact":
            ok = ok and torch.equal(a, b)
        else:
            ok = ok and torch.allclose(a, b, rtol=entry.rtol,
                                       atol=entry.atol)
    return ok, err


def contract_launches(entries=None, device: str = "cuda"
                      ) -> Tuple[List[Finding], Dict[str, dict]]:
    """Launch every entry once at points[0] on `device` and hold it
    against its twin there. Returns (findings, {name: {"launches",
    "max_abs_err", "point"}})."""
    from repro_torch.kernels import ref
    entries = head_entries() if entries is None else entries
    out: List[Finding] = []
    facts: Dict[str, dict] = {}
    for e in entries:
        point = e.points[0]
        try:
            args, kwargs = _to(e.make_args(point), device)
            before = e.kernel.launches
            got = e.fn(*args, **kwargs)
            launched = e.kernel.launches - before
            want = (e.twin_call(args, kwargs) if e.twin_call is not None
                    else getattr(ref, e.twin)(*args, **kwargs))
            ok, err = compare(e, got, want)
        except Exception as ex:  # noqa: BLE001 — a failed launch is a finding
            out.append(Finding("contract-launch", *entry_loc(e),
                               f"{e.name}: {type(ex).__name__}: {ex}"))
            continue
        facts[e.name] = {"launches": launched, "max_abs_err": err,
                         "point": point}
        if launched < 1:
            out.append(Finding("contract-launch", *entry_loc(e),
                               f"{e.name}: the wrapper launched nothing at "
                               f"{point} on {device}"))
        if not ok:
            tol = ("exactly" if e.exactness == "exact" else
                   f"within rtol {e.rtol:g}, atol {e.atol:g}")
            out.append(Finding("contract-launch", *entry_loc(e),
                               f"{e.name}: disagrees with {e.twin} at "
                               f"{point} (max abs err {err:.3g}; must agree "
                               f"{tol})"))
    return out, facts

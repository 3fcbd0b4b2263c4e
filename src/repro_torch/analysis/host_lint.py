"""AST lint of the port's host reads and unseeded draws. Takes the place
of `repro/analysis/trace_lint.py`.

Eager PyTorch has no traced context, so the JAX lint's `traced-host-cast`
(a host cast inside jit / a Pallas body / a lax loop body) and `host-if`
(a Python `if` on a traced value) have no counterpart: every value is
concrete, and what costs is the wait. Two rules, over `core/`,
`kernels/`, `launch/`, `service/`, `train/` and `checkpoint/` of
`repro_torch` (the JAX lint's scopes):

  * `host-sync`: a call that waits for the device and copies its values
    to the host: `.item()`, `.tolist()`, `.numpy()`, `.cpu()`,
    `.to("cpu")` (a string or `torch.device("cpu")`, positional or
    `device=`), `torch.cuda.synchronize(...)`, and `int(...)`,
    `float(...)` or `bool(...)` applied directly to a tensor method call
    (`.sum()`, `.max()`, `.any()`, ...; numpy, math and statistics
    functions are not tensor methods). A genuine host path (telemetry
    after the round, the ledger, checkpoints, reports) carries
    `# analysis: host-ok <why>` on one of the lines of the flagged call;
    the comment covers that call only. The count of such comments is
    pinned in `exemptions.py` (`host-ok-drift`, a warning that fails
    `--strict`), and a comment that exempts nothing is `host-ok-unused`
    (a warning too).
  * `unseeded-draw` (the counterpart of `unseeded-key`): a random draw
    that accepts `generator=` (`torch.rand`, `randn`, `randint`,
    `randperm`, `normal`, `bernoulli`, `multinomial`, `poisson`, the
    `*_like` draws, the in-place `uniform_` / `normal_` / `random_` ...
    and `torch.nn.init`'s) called without one: its numbers depend on
    the global generator's history, not on the run's seed.
"""
from __future__ import annotations

import ast
import io
import os
import tokenize
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.report import Finding

HOST_OK_MARK = "analysis: host-ok"
DEFAULT_LINT_DIRS = ("core", "kernels", "launch", "service", "train",
                     "checkpoint")

_HOST_METHODS = {"item", "tolist", "numpy", "cpu"}
_CASTS = {"int", "float", "bool"}
# tensor methods whose int/float/bool is a read of a device value
_REDUCTIONS = {"sum", "max", "min", "any", "all", "mean", "prod", "norm",
               "argmax", "argmin", "amax", "amin", "count_nonzero", "std",
               "var", "median", "logsumexp", "nansum", "item", "dot"}
# receivers whose methods are not tensor methods
_HOST_MODULES = {"np", "numpy", "math", "statistics"}
_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
          "multinomial", "poisson", "rand_like", "randn_like",
          "randint_like"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                  "bernoulli_", "geometric_", "log_normal_", "cauchy_"}


def _dotted(node) -> Optional[str]:
    """`torch.cuda.synchronize` -> "torch.cuda.synchronize"; None for
    anything that is not a chain of names."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_cpu(node) -> bool:
    """"cpu" or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and (_dotted(node.func) or "").endswith(
            "device") and node.args:
        return _is_cpu(node.args[0])
    return False


def _host_sync(node: ast.Call) -> Optional[str]:
    """What the call reads to the host, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _HOST_METHODS:
            return f".{f.attr}()"
        if f.attr == "to" and (
                (node.args and _is_cpu(node.args[0]))
                or any(k.arg == "device" and _is_cpu(k.value)
                       for k in node.keywords)):
            return '.to("cpu")'
    name = _dotted(f) or ""
    if name.endswith("cuda.synchronize"):
        return "torch.cuda.synchronize()"
    if name in _CASTS and len(node.args) == 1:
        a = node.args[0]
        if isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute) \
                and a.func.attr in _REDUCTIONS:
            root = _dotted(a.func.value) or ""
            if root.split(".")[0] not in _HOST_MODULES:
                return f"{name}(.{a.func.attr}())"
    return None


def _unseeded(node: ast.Call) -> Optional[str]:
    """The draw's name when it takes generator= and was given none."""
    if any(k.arg == "generator" for k in node.keywords):
        return None
    f = node.func
    name = _dotted(f) or ""
    if name.startswith("torch.") and name.count(".") == 1 and \
            name.split(".")[1] in _DRAWS:
        return name
    if ".nn.init." in f".{name}" and name.endswith("_"):
        return name
    if isinstance(f, ast.Attribute) and f.attr in _INPLACE_DRAWS:
        return f".{f.attr}()"
    return None


def _host_ok_lines(src: str) -> List[Tuple[int, str]]:
    """(line, comment) of every `# analysis: host-ok` comment."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT and HOST_OK_MARK in tok.string:
                out.append((tok.start[0], tok.string.lstrip("# ").strip()))
    except tokenize.TokenError:
        pass
    return out


def lint_source(src: str, path: str) -> List[Finding]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("host-sync", path, e.lineno or 1,
                        f"syntax error: {e.msg}")]
    exempt = {line for line, _ in _host_ok_lines(src)}
    used: Set[int] = set()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        what = _host_sync(node)
        if what is not None:
            span = set(range(node.lineno, (node.end_lineno or node.lineno)
                             + 1))
            if span & exempt:
                used |= span & exempt
            else:
                findings.append(Finding(
                    "host-sync", path, node.lineno,
                    f"{what} waits for the device and reads its values to "
                    f"the host (justify with `# {HOST_OK_MARK} <why>`)"))
        draw = _unseeded(node)
        if draw is not None:
            findings.append(Finding(
                "unseeded-draw", path, node.lineno,
                f"{draw} draws from the global generator; pass "
                f"generator= derived from the run's seed"))
    for line in sorted(exempt - used):
        findings.append(Finding(
            "host-ok-unused", path, line,
            "this host-ok comment exempts no host read on its line",
            severity="warning"))
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule,
                                                f.message))


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def walk_py(paths):
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def lint_paths(paths) -> List[Finding]:
    out: List[Finding] = []
    for path in walk_py(paths):
        out.extend(lint_file(path))
    return out


def collect_host_ok(paths) -> List[Tuple[str, int, str]]:
    """The `# analysis: host-ok` inventory over `paths`: [(path, line,
    comment)], sorted; the CLI publishes it and `exemptions.py` pins its
    count."""
    out: List[Tuple[str, int, str]] = []
    for path in walk_py(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError:
            continue
        out.extend((path, line, why) for line, why in _host_ok_lines(src))
    return sorted(out)

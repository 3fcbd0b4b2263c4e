"""CLI: `python -m repro_torch.analysis [--strict] [--json PATH]
[--device cpu|cuda] [paths...]`. Counterpart of
`python -m repro.analysis`.

With no paths, the whole gate runs (`run_gate`):

  1. kernel contracts: the static checks of every entry (importing the
     kernel modules fills the registry) and the completeness walk over
     `kernels/csrc/*.cu` and every `CudaKernel`; on the card also
     `estimator-drift` and the contract launch of every entry;
  2. the privacy-taint check: the 16 head targets
     (`taint.head_targets`) on the device, the plain versions on the
     CPU and the kernels on the card;
  3. the host-sync lint over `repro_torch/{core,kernels,launch,service,
     train,checkpoint}` and the `# analysis: host-ok` inventory, its
     count pinned in `exemptions.py` (drift is a warning: it fails
     --strict only).

With paths: lint those files and directories instead, and import each
file that registers anything in isolation (`capture_registrations`,
`capture_targets`, `capture_declassifiers`): its kernel contracts get
the static checks and its file's completeness check, its taint targets
run on the device. This is how the fixtures under
`tests/torch_analysis_fixtures/` run without touching the HEAD
registries.

`--device` defaults to the card (`cuda`) and raises without one unless
`--device cpu` is given; the lint and the static contract checks need no
device, and the path mode asks for one only when a file registers taint
targets. Exit status: 0 when clean; 1 when any error-severity finding
exists (`--strict`: any finding, warnings included). `--json PATH` also
writes the deterministic, schema-versioned payload of `report.py`.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time
from typing import Dict, List, Optional

from repro_torch.analysis.privacy import capture_declassifiers
from repro_torch.analysis.registry import capture_registrations
from repro_torch.analysis.report import Finding, render_json, render_text

PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_lint_paths() -> List[str]:
    from repro_torch.analysis.host_lint import DEFAULT_LINT_DIRS
    return [os.path.join(PORT_ROOT, d) for d in DEFAULT_LINT_DIRS]


def resolve_device(name: str) -> str:
    """`name` if it can run, with TF32 off as the port's entry points set
    it; the card is the default and is not replaced by the CPU silently."""
    import torch

    from repro_torch.device import resolve_device as port_device
    if name not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {name!r} (cpu or cuda)")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the analysis gate runs on the card by default; "
            "pass --device cpu to run it on the CPU (the plain versions; no "
            "contract launches and no estimator drift)")
    port_device(name)
    return name


def host_ok_findings(lint_paths) -> tuple:
    """(inventory, findings): the host-ok sites and a `host-ok-drift`
    warning when their count is not the pin."""
    from repro_torch.analysis.exemptions import EXPECTED_HOST_OK
    from repro_torch.analysis.host_lint import collect_host_ok
    host_ok = [(os.path.relpath(p), ln, why)
               for p, ln, why in collect_host_ok(lint_paths)]
    out = []
    if len(host_ok) != EXPECTED_HOST_OK:
        out.append(Finding(
            "host-ok-drift", "src/repro_torch/analysis/exemptions.py", 1,
            f"{len(host_ok)} `# analysis: host-ok` exemptions under the "
            f"default lint dirs, pin says {EXPECTED_HOST_OK} — update the "
            f"pin alongside the new or removed exemption",
            severity="warning"))
    return host_ok, out


def run_gate(device: str) -> Dict:
    """The whole gate on `device`. Returns {"findings", "entries",
    "taint_targets", "host_ok", "lint_paths", "seconds" (per part),
    "contracts" (per entry on the card: launches, max_abs_err, point),
    "estimator_checks", "taint_launches" (kernel launches made by the
    taint run, per CudaKernel name), "taint_kernels" (wrappers whose
    rule fired)}."""
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.analysis import taint
    from repro_torch.analysis.host_lint import lint_paths

    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    findings: List[Finding] = []
    entries = kc.head_entries()
    findings += kc.check_entries(entries) + kc.completeness_findings(entries)
    contracts, n_est = {}, 0
    if device == "cuda":
        est, n_est = kc.estimator_findings(entries)
        launched, contracts = kc.contract_launches(entries, device)
        findings += est + launched
    seconds["contracts"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    targets = taint.head_targets(device)
    before = {e.name: e.kernel.launches for e in entries}
    fired = set()
    for t in targets:
        run = taint.run_target(t)
        findings += run.findings
        fired |= run.engine.kernels
    taint_launches = {e.name: e.kernel.launches - before[e.name]
                      for e in entries}
    seconds["taint"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    paths = default_lint_paths()
    findings += lint_paths(paths)
    host_ok, drift = host_ok_findings(paths)
    findings += drift
    seconds["lint"] = time.perf_counter() - t0
    return {"findings": findings, "entries": [e.name for e in entries],
            "taint_targets": [t.name for t in targets],
            "host_ok": host_ok, "lint_paths": paths, "seconds": seconds,
            "contracts": contracts, "estimator_checks": n_est,
            "taint_launches": taint_launches,
            "taint_kernels": sorted(fired)}


def _registers(path: str) -> bool:
    """Does the file define a kernel or register a contract or a taint
    target? A textual pre-check, so only such files are imported."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
    except OSError:
        return False
    return any(k in src for k in ("kernel_contract(", "CudaKernel(",
                                  "taint_target("))


def check_fixture_file(path: str, device=None) -> List[Finding]:
    """Import one file in isolation and check what it registers; `device`
    (a callable giving the device name) is asked for only when the file
    registers taint targets."""
    from repro_torch.analysis.kernel_contracts import (
        check_entries, completeness_file_findings)
    from repro_torch.analysis.taint import capture_targets, check_targets
    name = "_analysis_target_" + os.path.splitext(os.path.basename(path))[0]
    with capture_registrations() as entries, \
            capture_targets() as targets, capture_declassifiers():
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:  # noqa: BLE001 — an import failure is a finding
            return [Finding("taint-trace-error", path, 1,
                            f"import failed: {type(e).__name__}: {e}")]
    findings = check_entries(entries)
    findings += completeness_file_findings(path, entries, mod)
    if targets:
        dev = device() if callable(device) else (device or "cpu")
        findings += check_targets(targets, device=dev)
    return findings


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel contracts + host-sync lint + privacy-taint "
                    "check of the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyse (default: the whole gate)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on ANY finding, warnings included")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the JSON report to PATH")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the taint targets and the contract launches "
                         "run (default: the card; raises without one)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.host_lint import lint_paths, walk_py

    t0 = time.monotonic()
    checked: List[str] = []
    taint_names: List[str] = []
    host_ok = None
    if args.paths:
        findings: List[Finding] = []
        lint_targets = list(args.paths)
        for f in walk_py(args.paths):
            if _registers(f):
                checked.append(os.path.relpath(f))
                findings += check_fixture_file(
                    f, lambda: resolve_device(args.device))
        findings += lint_paths(lint_targets)
        device = args.device
    else:
        device = resolve_device(args.device)
        gate = run_gate(device)
        findings, checked = gate["findings"], gate["entries"]
        taint_names, host_ok = gate["taint_targets"], gate["host_ok"]
        lint_targets = gate["lint_paths"]

    findings = sorted(set(findings),
                      key=lambda f: (f.path, f.line, f.rule, f.message))
    wall = time.monotonic() - t0
    print(render_text(findings))
    if args.json:
        payload = render_json(findings, strict=args.strict, device=device,
                              checked_entries=checked,
                              linted_paths=[os.path.relpath(p)
                                            for p in lint_targets],
                              taint_targets=taint_names, host_ok=host_ok,
                              wall_time_s=wall)
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(payload + "\n")
        print(f"report written to {args.json}")
    if args.strict:
        return 1 if findings else 0
    return 1 if any(f.severity == "error" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(run())

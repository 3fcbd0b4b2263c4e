"""Finding record and report formatting of `repro_torch.analysis`
(standard library only). Counterpart of `repro/analysis/report.py`."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

# bump when the JSON payload's shape changes, so two reports compare
SCHEMA_VERSION = 1

# rule id -> one-line description; the ids shared with the JAX package
# keep its meaning
RULES = {
    "oracle-missing": "declared plain twin not found in kernels/ref.py",
    "unregistered-kernel": "an exported C symbol under kernels/csrc that "
                           "no entry launches or declares as a helper, "
                           "or a CudaKernel with no registry entry",
    "symbol-missing": "an entry's launch symbol is not exported by its "
                      "CUDA source",
    "estimator-missing": "a declared C helper (shared-memory mirror or "
                         "launch query) is not exported by the entry's "
                         "source, or an estimator names an undeclared one",
    "estimator-drift": "a Python shared-memory function and its C mirror "
                       "disagree at an entry's shapes (on the card)",
    "contract-launch": "a kernel failed to launch at its representative "
                       "shape or disagreed with its plain twin beyond its "
                       "exactness class (on the card)",
    "host-sync": "a host read of device values (.item / .tolist / "
                 ".numpy / .cpu / .to(\"cpu\") / torch.cuda.synchronize / "
                 "int|float|bool of a tensor method call) without an "
                 "`# analysis: host-ok` justification",
    "unseeded-draw": "a random draw that accepts generator= called "
                     "without one",
    "host-ok-drift": "the `# analysis: host-ok` inventory changed without "
                     "updating analysis/exemptions.py",
    "host-ok-unused": "an `# analysis: host-ok` comment on a line with no "
                      "host read to exempt",
    "taint-sink": "a value tainted by a private source (client params, "
                  "optimizer state, local batches) reaches a declared "
                  "disclosure sink with no declassifier on the path",
    "taint-host-read": "a value tainted by a private source is read to "
                       "the host (item, tolist, numpy, int/float/bool, "
                       "cpu): device data leaving undeclassified",
    "taint-trace-error": "a taint target failed to run, or its label tree "
                         "does not mirror its arguments (the disclosure "
                         "boundary of that entry point is UNVERIFIED)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"  # "error" | "warning"

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def __str__(self) -> str:
        return f"{self.location()}: [{self.rule}] {self.message}"


def render_text(findings: List[Finding]) -> str:
    if not findings:
        return "repro_torch.analysis: clean (0 findings)"
    lines = [str(f) for f in findings]
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    lines.append(f"repro_torch.analysis: {len(findings)} finding(s) "
                 f"({summary})")
    return "\n".join(lines)


def render_json(findings: List[Finding], *, strict: bool, device: str,
                checked_entries: Optional[List[str]] = None,
                linted_paths: Optional[List[str]] = None,
                taint_targets: Optional[List[str]] = None,
                host_ok: Optional[List] = None,
                wall_time_s: Optional[float] = None) -> str:
    """The `--json` payload. Deterministic apart from `wall_time_s`: the
    findings sorted by (path, line, rule, message), every other list
    sorted, keys sorted, `schema_version` stamping the shape. `host_ok`
    is the exemption inventory [(path, line, why)]; `taint_targets` the
    entry points checked."""
    ordered = sorted(findings,
                     key=lambda f: (f.path, f.line, f.rule, f.message))
    rules: Dict[str, Dict] = {}
    for f in ordered:
        r = rules.setdefault(f.rule, {"count": 0, "locations": []})
        r["count"] += 1
        r["locations"].append(f"{f.location()} {f.message}")
    payload = {
        "schema_version": SCHEMA_VERSION,
        "clean": not findings,
        "strict": strict,
        "device": device,
        "total": len(findings),
        "findings": [dataclasses.asdict(f) for f in ordered],
        "rules": rules,
        "kernel_entries": sorted(checked_entries or []),
        "linted_paths": sorted(linted_paths or []),
        "taint_targets": sorted(taint_targets or []),
        "host_ok": {
            "count": len(host_ok or []),
            "sites": sorted(f"{p}:{ln} {why}"
                            for p, ln, why in (host_ok or []))},
    }
    if wall_time_s is not None:
        payload["wall_time_s"] = round(float(wall_time_s), 3)
    return json.dumps(payload, indent=1, sort_keys=True)

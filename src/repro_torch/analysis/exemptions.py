"""Pinned `# analysis: host-ok` inventory of the host-sync lint.
Counterpart of `repro/analysis/exemptions.py`.

A genuine host path escapes the lint with an `# analysis: host-ok <why>`
comment on the line of its host read. Silently accumulating exemptions
would erode the gate one comment at a time, so the COUNT is pinned here:
the CLI's default run collects the inventory (`host_lint.collect_host_ok`
over the default lint dirs), publishes every site in the JSON report
(`host_ok.sites`) and reports `host-ok-drift`, a warning, when the count
moves; `--strict` fails on it. Adding or removing an exemption is a
two-line change by design: the comment with its justification, and
this pin.
"""
from __future__ import annotations

# `# analysis: host-ok` comments under src/repro_torch/{core,kernels,
# launch,service,train,checkpoint}: the ledger's copies and hex
# (chain, launch/fed, transport), round telemetry, history and wall time
# (rounds), the ANN occupancy report, the service's fault plan and period
# report (driver), the staleness exp on the CPU (membership), the served
# reply, the LM launcher's tokens, member ids and timing, the federation
# dry run's clock, and checkpoints. The client axis is one vmapped call,
# so no forward loop reads neighbour or peer ids to the host.
EXPECTED_HOST_OK = 20

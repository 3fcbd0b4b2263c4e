"""Seeded-leak fixture: `taint-host-read` — a metrics tap that reads a
parameter-derived value to the host WITHOUT the `round-telemetry`
declassifier. The check flags the read even though the value is a mere
scalar mean. The lint's `host-ok` exemption on that line does not
declassify anything: the two layers are independent. Twin of
`tests/analysis_fixtures/leak_metric_tap.py` (`taint-callback` there)."""
import torch

from repro_torch.analysis.taint import SRC_PARAMS, taint_target


def leaky_tap(params_vec):
    mean = params_vec.mean()
    # BUG: device -> host crossing with no declassifier on the path
    mean.item()  # analysis: host-ok the tap's read; the taint check flags it
    return mean


taint_target(
    name="leak-metric-tap",
    build=lambda: (leaky_tap,
                   (torch.ones((4, 8), dtype=torch.float32),),
                   (SRC_PARAMS,)))

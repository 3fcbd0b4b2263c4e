"""The benchmark harness of the PyTorch/CUDA port (`repro_torch`).

`run.py` is the command; everything a cell needs is found by name:
`configs/<config>.json`, `traffic/<traffic>.json`, `cells/<cell>.json`
(the cell's frozen FLOP count and the limits of its correctness check)
and `metrics/<metric>.py` (one reader per per-layer metric).
`reference/` is the plain PyTorch reference the check holds the port
to; it imports nothing of the port.
"""

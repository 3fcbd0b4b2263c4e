"""The port's analysis gate: kernel contracts, a host-sync lint and the
privacy-taint check. Counterpart of `repro/analysis/`.

Three layers, one CLI (`python -m repro_torch.analysis`):

  * `registry` / `kernel_contracts`: one entry per hand-written CUDA
    kernel (wrapper, `CudaKernel`, the JAX contract it stands for, its
    plain twin in `kernels/ref.py`, exactness class, C helpers, a
    representative shape), a completeness walk over `kernels/csrc/*.cu`
    and every `CudaKernel`, and on the card a launch of every entry
    against its twin and the shared-memory mirrors held equal.
  * `host_lint`: an AST lint over `core/`, `kernels/`, `launch/`,
    `service/`, `train/` and `checkpoint/` for host reads of device
    values (exempted case by case by `# analysis: host-ok <why>`, the
    count pinned in `exemptions.py`) and random draws without a
    generator.
  * `privacy` / `taint`: the trust-free disclosure boundary as a
    dataflow checked on the protocol's entry points as they run: only
    `@declassifier` functions let values derived from private sources
    reach a `sink(...)` or the host.

`registry`, `privacy` and `report` import only the standard library so
the protocol and kernel modules attach their registrations at import
time without a cycle; the checkers import torch and the port.
"""
from repro_torch.analysis.privacy import (DECLASSIFIERS, SINKS,  # noqa: F401
                                          declassifier, sink)
from repro_torch.analysis.registry import (REGISTRY,  # noqa: F401
                                           kernel_contract)
from repro_torch.analysis.report import Finding  # noqa: F401

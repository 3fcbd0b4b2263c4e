"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source under `kernels/csrc/` has a plain C interface (no PyTorch
headers), so `nvcc` takes seconds per file. A source is compiled for
`sm_90a` at its first use, into `build/repro_torch/` at the root of the
checkout (listed in `.gitignore`), under a name keyed by a hash of the
source and the flags; a later process reuses the library. A missing
`nvcc` or a failed compile raises. `build_all` compiles several sources
at once, one `nvcc` process per source (two kernels may share one).

Every exported C function launches on the stream it is given and
returns `cudaGetLastError()` after its launches; `CudaKernel.launch`
raises when that is not 0, because a refused launch never runs and no
later synchronise reports it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# dynamic shared memory one H100 block may use (227 KB of the SM's 256)
MAX_SHARED_BYTES = 227 * 1024
# devices on which every wrapper takes its kernel's plain version: the CPU
# (no card: the tests) and `meta` (shapes only, nothing is computed: the
# dryrun counts a step's FLOPs there). Any other device but CUDA raises.
PLAIN_DEVICES = ("cpu", "meta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler, from PATH or CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the port's CUDA kernels cannot be built")


class CudaKernel:
    """One hand-written kernel: its source, its library and its launch
    count. `launches` is a plain integer that `launch` raises by one per
    call of the C entry point; callers may reset it. `argtypes` are the
    entry point's own arguments; every entry point also takes the device
    index and the stream, last."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: List[type]):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:16]}.so"

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish_build(self, started) -> None:
        """Wait for a build from `_start_build`; move the library into
        place (atomically, so a concurrent process never loads half a file)."""
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.library_path())

    def function(self):
        """The loaded C entry point, building the library if needed."""
        if self._fn is None:
            self._finish_build(self._start_build())
            self._lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def helper(self, symbol: str, argtypes: List[type]):
        """Another exported C function of the same library (one that
        launches nothing, e.g. a query of the launch's choice)."""
        self.function()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device` and its current stream (the C entry point
        takes both after `args`); raise on a launch error."""
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self.function()(*args, index, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, str]:
    """Compile every kernel's source at once (one nvcc per source) and
    load them. Returns {name: nvcc log} for the sources compiled now."""
    kernels = list(kernels)
    by_library = {}                # one nvcc per source, by its first kernel
    for k in kernels:
        by_library.setdefault(k.library_path(), k)
    owners = list(by_library.values())
    started = [k._start_build() for k in owners]
    errors = []
    for k, s in zip(owners, started):       # wait for every nvcc first
        try:
            k._finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.function()
    return {k.name: k.build_log for k, s in zip(owners, started) if s}

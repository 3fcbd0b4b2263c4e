#!/usr/bin/env python3
"""Show what the selection kernels of `csrc/selection.cu` (one-shot,
column-tiled and grouped ANN) compile to on a CUDA machine.

    python3 scripts/torch_selection_sass.py

Builds `src/repro_torch/kernels/csrc/selection.cu` (as the port does, at
first use) and prints one JSON line per kernel instance: its registers,
stack and spills from `nvcc -Xptxas -v`, and how many tensor-core
instructions (`BMMA`, `IMMA`, `HMMA`, `GMMA`) and `POPC` its SASS holds
(`cuobjdump -sass`). Needs nvcc and cuobjdump (CUDA_HOME, default
/usr/local/cuda); no card is needed.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OPS = ("BMMA", "IMMA", "HMMA", "GMMA", "POPC")


def short(name: str) -> str:
    """fused_select_kernel<8, true> (select_ann_grouped_kernel<8, true,
    16>) from a mangled kernel name."""
    m = re.search(r"(fused_select_kernel|select_tiled_kernel|"
                  r"select_ann_grouped_kernel)ILi(\d+)ELb(\d)E(?:Li(\d+)E)?",
                  name)
    if not m:
        return name
    tail = f", {m.group(4)}" if m.group(4) else ""
    return f"{m.group(1)}<{m.group(2)}, {bool(int(m.group(3)))}{tail}>"


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import selection
    kernel = selection.KERNEL
    kernel._finish_build(kernel._start_build())
    ptxas = {}
    cur = None
    for line in kernel.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = short(m.group(1))
            ptxas[cur] = {}
        elif cur and "Used" in line:
            ptxas[cur]["registers"] = int(re.search(r"Used (\d+) reg",
                                                    line).group(1))
        elif cur and "spill" in line:
            ptxas[cur]["stack_spills"] = line.strip()
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(kernel.library_path())], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = short(m.group(1))
            counts[cur] = dict.fromkeys(OPS, 0)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur and op and op.group(1) in OPS:
            counts[cur][op.group(1)] += 1
    for name, c in counts.items():
        print(json.dumps({"kernel": name, **ptxas.get(name, {}), **c}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

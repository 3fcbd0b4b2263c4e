#!/usr/bin/env python3
"""Show what the flash-attention kernel of `csrc/flash_attention.cu`
compiles to on a CUDA machine.

    python3 scripts/torch_flash_sass.py [--root DIR]

Builds DIR/src/repro_torch/kernels/csrc/flash_attention.cu (default: this
checkout; as the port does, at first use) and prints one JSON line per
kernel instance: its configuration (value type, head dim, warpgroups,
keys per stage, stages, Q buffers, blocks per SM, and whether it is the
instance for aligned rows), registers and spills from `nvcc -Xptxas -v`,
and, in its loop over K/V tiles (the innermost loop that holds the
`HGMMA`s), the instruction count and how many of them are `HGMMA`,
`R2UR` (a value moved into a uniform register: a wgmma descriptor built
off the uniform datapath costs one or two a product), `LDL`/`STL`
(spills), `SYNCS` (mbarrier operations) and `BAR` (named and block
barriers), from `cuobjdump -sass`. Needs nvcc and cuobjdump (CUDA_HOME,
default /usr/local/cuda); no card is needed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OPS = ("HGMMA", "R2UR", "LDL", "STL", "SYNCS", "BAR")


def short(name: str) -> str:
    """`f32 <64, 2, 64, 2, 2, 1> vec` from a mangled kernel name (the
    `Cfg` arguments after the head dim; `vec`: the aligned instance)."""
    m = re.search(r"CfgI(13__nv_bfloat16|f)((?:Li\d+E)+)EE(?:S\d+_|f)"
                  r"(?:Lb(\d)E)?", name)
    if not m:
        return name
    args = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
    kind = "bf16" if "bfloat16" in m.group(1) else "f32"
    vec = {"1": " vec", "0": " staged"}.get(m.group(3) or "", "")
    return f"{kind} <{args}>{vec}"


def tile_loop(body: str) -> Counter:
    """Instruction counts of the loop that closes after the last HGMMA:
    from the target of the first backward branch past it to that
    branch."""
    ins = [(int(a, 16), t) for a, t in
           re.findall(r"/\*([0-9a-f]{4,6})\*/\s+(.*?);", body)]
    hg = [i for i, (_, t) in enumerate(ins) if "HGMMA" in t]
    if not hg:
        return Counter()
    for a, t in ins[hg[-1]:]:
        m = re.search(r"BRA (?:\S+, )?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= ins[hg[0]][0]:
            lo, hi = int(m.group(1), 16), a
            ops = [t.split()[1] if t.startswith("@") else t.split()[0]
                   for b, t in ins if lo <= b <= hi]
            c = Counter(o.split(".")[0] for o in ops)
            c["instructions"] = len(ops)
            return c
    return Counter()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import tempfile

    from repro_torch.kernels import build, flash_attention
    kernel = flash_attention.KERNEL
    kernel._finish_build(kernel._start_build())
    log = kernel.build_log
    if not log:                # built before: compile again for ptxas -v
        with tempfile.TemporaryDirectory() as tmp:
            log = subprocess.run(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(Path(tmp) / "flash.so"), str(kernel.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, check=True).stdout
    ptxas, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = short(m.group(1))
            ptxas[cur] = {}
        elif cur and "Used" in line:
            ptxas[cur]["registers"] = int(re.search(r"Used (\d+) reg",
                                                    line).group(1))
        elif cur and "spill stores" in line:
            ptxas[cur]["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(kernel.library_path())], capture_output=True,
                          text=True, check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = short(func.split("\n", 1)[0])
        loop = tile_loop(func)
        print(json.dumps({"instance": name, **ptxas.get(name, {}),
                          "tile_loop": {k: loop[k] for k in
                                        ("instructions",) + OPS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

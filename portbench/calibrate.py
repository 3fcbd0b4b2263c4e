"""Readings behind the check's limits, at a cell's own size, in one
process (the kernels built once):

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--out FILE]

For each seed, the run's set-up and first rounds as `run.py` makes them
(one reselection period of window), then the check; the program as the
configuration states it ("sound"), in TF32 ("tf32", the control: the
program's own lower precision) and with half of each minibatch left out
("half_batch"). One JSON line per run: mode, seed, each number compared,
`param_gap` round by round.
The lower reading of a number is the largest over the sound seeds; its
upper reading the smallest over a control's or fault's seeds.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import cells, faults, harness  # noqa: E402


def reading(cell, seed, mode):
    proto = cell["config_data"]["protocol"]
    opts = harness.Options(
        device="cuda", tf32=mode == "tf32",
        wrap_program=faults.FAULTS[mode](proto) if mode in faults.FAULTS
        else None)
    rounds = []

    def log(line):
        got = json.loads(line)["info"].get("check")
        if isinstance(got, dict) and "round" in got:
            rounds.append([got["round"], got["param_gap"]])

    t0 = time.perf_counter()
    res = harness.execute(cell, seed, 0.0, False, opts, log=log)
    out = {"mode": mode, "seed": seed, "correct": res["correct"],
           "checks": res["checks"], "param_gap_by_round": rounds,
           "s": time.perf_counter() - t0}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    for mode in ("sound", "tf32", "half_batch"):
        n = args.seeds if mode == "sound" else args.control_seeds
        for i in range(n):
            line = json.dumps(reading(cell, args.first_seed + i, mode))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

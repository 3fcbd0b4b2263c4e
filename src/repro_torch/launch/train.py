"""Training entry point of the transformer zoo (the port of
`repro/launch/train.py`): AdamW under a linear-warmup cosine schedule on
the synthetic token stream, with checkpoint and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch phi3-medium-14b --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --full --steps 4 --batch 2 --seq 512 --remat block
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --full --steps 4 --batch 2 --seq 512 \\
        --remat block

Every arch of the zoo trains: the dense models, the MoE (the load-balance
term in the loss), the RG-LRU hybrid, xLSTM, the Whisper
encoder-decoder and the cross-attention VLM, whose batches carry the
stream's audio frames or vision patches to the device with the tokens.
Runs on the CUDA device unless `--device` names another. The reduced
config is the default; `--full` takes the published widths and depth.
In f32, params, grads and AdamW moments take 16 bytes a parameter:
Minitron-4B 67 GB, recurrentgemma-2b 57 GB, whisper-small and
xlstm-350m under 7 GB fit one 80 GB card; grok-1, kimi-k2 and
llama-3.2-vision do not, even at one layer. The JAX launcher's `unroll`
/ `scan_unroll` are knobs of its `lax.scan`; the port runs its layers in
a Python loop and has no counterpart.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.train import init_train_state, make_train_step


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, reduced: bool = True, ckpt_dir: str = "",
          ckpt_every: int = 0, seed: int = 0, log_every: int = 10,
          remat: str = "none", device=None, log=print):
    """Train `arch` for `steps` steps and return (params, history).

    The weights are drawn from a `torch.Generator` seeded `seed` on the
    device. With `ckpt_dir` the run resumes from its latest snapshot
    (params and optimizer state, `restore` in place) and the token stream
    resumes at that step, so a resumed run equals an uninterrupted one;
    the JAX launcher restarts its stream at batch 0 instead. Snapshots are
    saved every `ckpt_every` steps and at the end. Every `log_every`-th
    step (and the last) reads loss and grad norm back to the host and
    appends {"step", "loss", "grad_norm", "elapsed_s"} to the history,
    `elapsed_s` the seconds since the loop started."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    stream = TokenStream(cfg, batch, seq, seed=seed)
    opt = adamw(linear_warmup_cosine(lr, max(steps // 10, 1), steps),
                weight_decay=0.1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params, opt_state = init_train_state(cfg, opt, gen)

    start = 0
    if ckpt_dir and (last := ckpt.latest_step(ckpt_dir)) is not None:
        params, opt_state = ckpt.restore(ckpt_dir, last, (params, opt_state))
        start = stream.step = last
        if log:
            log(f"restored step {last} from {ckpt_dir}")

    step_fn = make_train_step(cfg, opt, remat=remat)
    history = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch_t = {k: torch.as_tensor(v, device=dev)
                   for k, v in stream.next_batch().items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_t)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            elapsed = time.perf_counter() - t0
            history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "elapsed_s": elapsed})
            if log:
                log(f"step {step:5d} loss {loss:8.4f} gnorm {gnorm:7.3f} "
                    f"({elapsed:.1f}s)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state))
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, (params, opt_state))
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--remat", default="none", choices=["none", "block"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    _, history = train(args.arch, steps=args.steps, batch=args.batch,
                       seq=args.seq, lr=args.lr, reduced=not args.full,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       seed=args.seed, remat=args.remat, device=args.device)
    print(json.dumps(history[-3:], indent=1))


if __name__ == "__main__":
    main()

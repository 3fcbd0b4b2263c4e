"""Train a ~100M-parameter LM from the zoo on the PyTorch port (the
counterpart of `examples/train_lm.py`): a few hundred steps on the
synthetic token stream: end-to-end training at transformer scale.

xlstm-350m's reduced() variant is widened here to ~100M parameters (4
layers, d 768, 8 heads of 96, vocabulary 32,768), registered under its
own name and trained through `launch.train.train(reduced=False)`.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 4

Runs on the CUDA device unless `--device` names another. No kernel of
the port lies on a training path (the flash kernel has no backward).
Weights from a `torch.Generator` seeded 0. `main` returns the parameter
count, the first and last loss and the seconds a step.
"""
import argparse
import dataclasses
import time

from repro_torch.configs import get_config, register
from repro_torch.device import resolve_device
from repro_torch.launch.train import train


def widened_config(arch: str):
    """~100M parameters: the reduced config of `arch`, widened."""
    base = get_config(arch)
    return dataclasses.replace(
        base.reduced(), name=base.name + "-100m",
        num_layers=4, d_model=768, num_heads=8, num_kv_heads=8,
        head_dim=96, vocab_size=32768)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = widened_config(args.arch)
    n = cfg.param_count()
    print(f"training {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    # register the custom config so `train` can find it
    register(cfg.name)(lambda: cfg)
    t0 = time.perf_counter()
    _, history = train(cfg.name, steps=args.steps, batch=args.batch,
                       seq=args.seq, lr=6e-4, reduced=False,
                       log_every=max(args.steps // 10, 1), device=dev)
    wall = time.perf_counter() - t0
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return {"params": n, "steps": args.steps, "loss_first": first,
            "loss_last": last, "s_per_step": wall / args.steps}


if __name__ == "__main__":
    main()

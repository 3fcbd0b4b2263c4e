"""Batched serving on the PyTorch port (the counterpart of
`examples/serve_batch.py`): prefill a batch of prompts, decode with a KV
cache, report tokens/s, including the sliding-window serving variant
used by the long_500k dry-run shape.

    PYTHONPATH=src python examples/torch_serve_batch.py
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

Runs on the CUDA device unless `--device` names another; there the
prefills of phi3 (window 0) and whisper launch the flash-attention
kernel, and the window-16 run and recurrentgemma take the plain
attention (the kernel has no window). Reduced configs, random weights
from seed 0. `main` returns each run's prefill seconds and decode
tokens/s.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve

RUNS = (("phi3-medium-14b", 0),
        ("phi3-medium-14b", 16),      # sliding-window variant
        ("recurrentgemma-2b", 0),     # hybrid: ring + RG-LRU
        ("whisper-small", 0))         # enc-dec cross-attn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = []
    for arch, window in RUNS:
        res = serve(arch, batch=4, prompt_len=24, max_new=12, reduced=True,
                    window_override=window, device=dev)
        label = f"{arch}" + (f" (window={window})" if window else "")
        print(f"{label:40s} prefill {res['prefill_s']:.2f}s   "
              f"decode {res['decode_tok_per_s']:7.1f} tok/s   "
              f"sample {res['generated'][0][:6]}")
        out.append({"arch": arch, "window": window,
                    "prefill_s": res["prefill_s"],
                    "decode_tok_per_s": res["decode_tok_per_s"]})
    return {"runs": out}


if __name__ == "__main__":
    main()

"""Serving entry point of the transformer zoo: batched prefill and greedy
decode on a KV cache (the port of `repro/launch/serve.py`, LM mode; the
federated mode `serve_personalized` needs the service, a later slice).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch phi3-medium-14b --batch 2 --prompt-len 24 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch minitron-4b --full --batch 4 --prompt-len 2048 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch grok-1-314b --full --layers 2 --prompt-len 2048 --max-new 32

Every arch of the zoo is served: dense, MoE (grok-1, kimi-k2), the
RG-LRU hybrid (recurrentgemma), xLSTM, the encoder-decoder (whisper; the
audio frames are `data.modality_stub`'s) and the VLM (llama-3.2-vision,
with stub patch embeddings). Runs on the CUDA device unless `--device`
names another. On the card the prefill's "causal" and "bidir" attention
goes through the hand-written flash-attention kernel
(`kernels/csrc/flash_attention.cu`).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import modality_stub
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.train import make_prefill_step, make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32,
          max_new: int = 16, reduced: bool = True, seed: int = 0,
          window_override: int = 0, num_layers: int = 0, device=None,
          params=None):
    """Prefill `batch` prompts of `prompt_len` tokens and decode
    `max_new` tokens greedily. The prompts (and the audio / vision stubs)
    are the JAX package's (`np.random.RandomState(seed)`); the weights
    are `params` (e.g. from `models.convert.lm_params_from_jax`) or drawn
    from a `torch.Generator` seeded with `seed` on the device.
    `num_layers` > 0 cuts the (decoder) depth to that many layers, the
    cut one card forces on the largest archs at full width (grok-1 at 2
    of 64 layers is 46 GB of f32 weights); 0 keeps the config's depth.
    Returns the generated tokens
    (B, max_new), the prefill's seconds and the decode's tokens per
    second (device synchronised before every clock read), the logits each
    token was chosen from (max_new, B, V) f32 (row 0 the prefill's) and
    the params used."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(cfg, gen)
    rs = np.random.RandomState(seed)
    prompts = {"tokens": torch.as_tensor(
        rs.randint(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int64, device=dev)}
    prompts.update({k: torch.as_tensor(v, device=dev) for k, v in
                    modality_stub(cfg, batch, rs).items()})

    # ONE prefill, sized for prompt + generation up front (cache_len)
    prefill_step = make_prefill_step(cfg, window_override=window_override,
                                     cache_len=prompt_len + max_new)
    serve_step = make_serve_step(cfg, window_override=window_override)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, prompts)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out, seen = [tok], [logits]
        t0 = time.perf_counter()
        for i in range(max_new - 1):
            tok, logits, cache = serve_step(params, cache, tok,
                                            prompt_len + i)
            out.append(tok)
            seen.append(logits)
        gen_tokens = torch.stack(out, dim=1)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return {"generated": gen_tokens.cpu().numpy(),
            "prefill_s": t_prefill,
            "decode_tok_per_s": batch * (max_new - 1) / max(t_decode, 1e-9),
            "logits": torch.stack(seen),
            "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="transformer zoo arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, reduced=not args.full,
                window_override=args.window, num_layers=args.layers,
                seed=args.seed, device=args.device)
    print(f"prefill {res['prefill_s']:.2f}s, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s")
    print("sample:", res["generated"][0][:16])


if __name__ == "__main__":
    main()

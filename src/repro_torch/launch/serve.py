"""Serving entry points (the port of `repro/launch/serve.py`): the
transformer zoo's batched prefill and greedy decode on a KV cache
(`serve`), and the federation's per-client personalized models
(`serve_personalized`, `--federated`).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch phi3-medium-14b --batch 2 --prompt-len 24 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch minitron-4b --full --batch 4 --prompt-len 2048 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch grok-1-314b --full --layers 2 --prompt-len 2048 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --federated --dataset aecg --ckpt-dir /tmp/svc --requests 64

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
import functools
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
        torch.cuda.synchronize(dev)  # analysis: host-ok prefill/decode times


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
    return {"generated": gen_tokens.cpu().numpy(),  # analysis: host-ok tokens
            "prefill_s": t_prefill,
            "decode_tok_per_s": batch * (max_new - 1) / max(t_decode, 1e-9),
            "logits": torch.stack(seen),
            "params": params}


def serve_personalized(dataset: str = "mnist", *, ckpt_dir=None,
                       requests: int = 64, seed: int = 0,
                       reselect_every: int = 4, num_clients: int = 0,
                       device=None, log=print):
    """Serve batched inference from the federation's per-client
    personalized models. With `ckpt_dir` the models are the service's
    latest checkpoint (the kill/resume snapshot doubles as the serving
    snapshot; its ledger is recovered and verified); without, a fresh
    untrained federation. Requests draw test examples for random active
    clients (`np.random.RandomState(seed)`, the JAX package's draws) and
    go through `service.PersonalizedServer` in one flush. Returns the
    server's throughput summary, the served accuracy, the number of
    models, and the requests: `client_ids`, `example_ids` and the served
    `logits` (requests, C)."""
    from repro_torch.configs.paper_models import FedConfig, PAPER_FED_OPTIMA
    from repro_torch.core import init_state
    from repro_torch.data import DATASETS
    from repro_torch.launch.fed import MODEL_FOR
    from repro_torch.models.client import (apply_client_model,
                                           client_template, init_client_model)
    from repro_torch.optim import adam
    from repro_torch.service import (PersonalizedServer, ServiceConfig,
                                     checkpoint_num_clients,
                                     checkpoint_param_names,
                                     init_service_state, resume_service)
    dev = resolve_device(device)
    ds_fn = DATASETS[dataset]
    if ckpt_dir and num_clients == 0:
        # the checkpointed service fixed M when it started
        num_clients = checkpoint_num_clients(ckpt_dir)
    ds = ds_fn(seed=seed) if num_clients == 0 else \
        ds_fn(num_clients=num_clients, seed=seed)
    n_opt, alpha, gamma = PAPER_FED_OPTIMA[dataset]
    fed = FedConfig(num_clients=ds.num_clients, num_neighbors=n_opt,
                    alpha=alpha, gamma=gamma)
    mcfg = MODEL_FOR[dataset]()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    template = init_service_state(
        init_state(lambda g: init_client_model(mcfg, g, dev),
                   adam(fed.lr), fed, seed),
        ServiceConfig(reselect_every=reselect_every))
    if ckpt_dir:
        names = checkpoint_param_names(ckpt_dir)
        if names is not None and names != set(template.fed.params):
            raise ValueError(
                f"the checkpoint under {ckpt_dir!r} holds another client "
                f"model than {dataset!r}'s ({sorted(names)}); pass the "
                f"service's --dataset")
        state, _chain, _next = resume_service(ckpt_dir, template)
    else:
        state = template
    server = PersonalizedServer(apply_fn, state.fed.params)
    x_test = torch.from_numpy(ds.stacked()["x_test"])
    y_test = ds.stacked()["y_test"]
    rs = np.random.RandomState(seed)
    active = state.active.cpu().numpy()  # analysis: host-ok members
    active_ids = np.flatnonzero(active)
    cids, tids = [], []
    for _ in range(requests):
        cid = int(active_ids[rs.randint(len(active_ids))])
        t = rs.randint(x_test.shape[1])
        server.submit(cid, x_test[cid, t])
        cids.append(cid)
        tids.append(t)
    logits = np.stack(server.flush())
    acc = float(np.mean(logits.argmax(-1) == y_test[cids, tids]))
    res = {**server.throughput(), "served_acc": acc,
           "num_models": int(active_ids.size), "client_ids": cids,
           "example_ids": tids, "logits": logits}
    if log is not None:
        log(f"served {requests} requests from {active_ids.size} "
            f"personalized models: {res['requests_per_s']:.0f} req/s, "
            f"p50 {res['p50_latency_s'] * 1e3:.1f} ms, acc {acc:.3f}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="",
                    help="transformer zoo arch; omit with --federated")
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
    ap.add_argument("--federated", action="store_true",
                    help="serve the per-client personalized models of a "
                         "federation checkpoint (repro_torch.service)")
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "aecg", "seeg"])
    ap.add_argument("--ckpt-dir", default="",
                    help="[federated] service checkpoint directory (omit "
                         "for a fresh federation)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.federated:
        serve_personalized(args.dataset, ckpt_dir=args.ckpt_dir or None,
                           requests=args.requests, seed=args.seed,
                           device=args.device)
        return
    if not args.arch:
        ap.error("--arch is required unless --federated")
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, reduced=not args.full,
                window_override=args.window, num_layers=args.layers,
                seed=args.seed, device=args.device)
    print(f"prefill {res['prefill_s']:.2f}s, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s")
    print("sample:", res["generated"][0][:16])


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port (the counterpart of
`examples/quickstart.py`):

1. A WPFed federation round on synthetic non-IID data (the paper's core).
2. LSH codes + Hamming similarity through the port's kernels.
3. A reduced transformer from the zoo: one train step, prefill, decode.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs on the CUDA device unless `--device` names another; there the round
launches the batched LSH, one-shot selection and one-shot exchange
kernels, part 2 the single-client LSH and the Hamming kernels, and the
prefill the flash-attention kernel (the train step takes the plain
attention: the kernel has no backward). Weights and inputs are drawn
from `torch.Generator`s. `main` returns the printed numbers.
"""
import argparse
import functools

import torch

from repro_torch.configs import get_config
from repro_torch.configs.paper_models import FedConfig, mnist_cnn
from repro_torch.core import evaluate, init_state, make_wpfed_round
from repro_torch.data.federated import make_mnist_federated
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.client import (apply_client_model, client_template,
                                       init_client_model)
from repro_torch.models.transformer import prefill
from repro_torch.optim import adam, adamw
from repro_torch.train import (init_train_state, make_serve_step,
                               make_train_step)


def _generator(seed: int, device=None) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def wpfed_round(dev):
    print("== 1. one WPFed round (8 clients, non-IID synthetic MNIST) ==")
    fed = FedConfig(num_clients=8, num_neighbors=3, top_k=3, local_steps=2,
                    lsh_bits=128)
    ds = make_mnist_federated(num_clients=8, per_client=80,
                              ref_per_client=16)
    data = {k: torch.from_numpy(v).to(dev) for k, v in ds.stacked().items()}
    mcfg = mnist_cnn()
    apply_fn = functools.partial(apply_client_model, client_template(mcfg))
    opt = adam(fed.lr)
    state = init_state(lambda g: init_client_model(mcfg, g, dev), opt, fed,
                       0)
    round_fn = make_wpfed_round(apply_fn, opt, fed)
    state, metrics = round_fn(state, data)
    loss = float(metrics["mean_loss"])
    verified = float(metrics["valid_neighbor_frac"])
    acc = float(evaluate(apply_fn, state, data)["mean_acc"])
    print(f"  mean loss {loss:.3f}, LSH-verified neighbor fraction "
          f"{verified:.2f}")
    print(f"  accuracy after 1 round: {acc:.3f}")
    return {"mean_loss": loss, "valid_neighbor_frac": verified, "acc": acc}


def codes_and_distances(params_list):
    """The 256-bit LSH code of each params dict (seed 5) and the codes'
    all-pairs Hamming distances: ((K, 8) int32, (K, K) int32)."""
    codes = torch.stack([ops.lsh_code(p, seed=5, bits=256)
                         for p in params_list])
    return codes, ops.hamming_matrix(codes)


def lsh_and_hamming(dev):
    print("== 2. LSH codes + Hamming (the kernels on the card, their "
          "plain versions on the CPU) ==")
    p_a = {"w": torch.randn((4096,), generator=_generator(1)).to(dev)}
    p_b = {"w": p_a["w"] + 0.02 * torch.randn(
        (4096,), generator=_generator(2)).to(dev)}         # near-copy
    p_c = {"w": torch.randn((4096,), generator=_generator(3)).to(dev)}
    _, d = codes_and_distances((p_a, p_b, p_c))
    similar, unrelated = int(d[0, 1]), int(d[0, 2])
    print(f"  Hamming(similar)={similar}/256  "
          f"Hamming(unrelated)={unrelated}/256")
    return {"hamming_similar": similar, "hamming_unrelated": unrelated}


def transformer(dev):
    print("== 3. reduced phi3 config: train step + prefill/decode ==")
    cfg = get_config("phi3-medium-14b").reduced()
    opt2 = adamw(1e-3)
    params, opt_state = init_train_state(cfg, opt2, _generator(4, dev))
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=_generator(5)).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    step = make_train_step(cfg, opt2, remat="none")
    params, opt_state, m = step(params, opt_state, batch)
    loss = float(m["loss"])
    print(f"  train loss {loss:.3f}")
    with torch.no_grad():
        logits, cache = prefill(cfg, params, toks, cache_len=40)
        serve = make_serve_step(cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [int(tok[0])]
        for i in range(4):
            tok, _, cache = serve(params, cache, tok, 32 + i)
            out.append(int(tok[0]))
    print(f"  greedy continuation: {out}")
    return {"train_loss": loss, "greedy": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = {**wpfed_round(dev), **lsh_and_hamming(dev),
              **transformer(dev)}
    print("quickstart OK")
    return result


if __name__ == "__main__":
    main()

"""Inputs of a run, made on the device from `--seed`: the clients' data
and their initial weights. Both sides get the same tensors: the port
through its own entry points, the reference by calling these functions
again after the window.

The data maker is a PyTorch copy of the statistics of the port's
`data/federated.py` generators (which are numpy and build 10-40
clients), vectorised over the client axis so that thousands of clients
are made in a few device calls. It is not bit-equal to the numpy
pipeline:

  mnist  28x28x1 images: one blurred template per class plus noise
         (0.35 on the reference pool, 0.35 and 0.2 more on the clients'
         pool); each client sees 5 classes, two shards of half its
         examples, each shard missing one of the 5; clients alternate
         between two clusters whose labels are (y + 5c) mod 10; a 7:3
         train/test split (the train part is kept); R reference
         examples of the reference pool, labels under the client's map.
  aecg   60-step RR-interval series: class = oscillation band, a common
         rhythm, a subject signature scaling the signal, noise 0.4;
         records x 3 sliding windows (80 % of the length, zero-padded);
         20 % of each subject's windows go to the shared reference pool;
         labels shifted by the subject's cohort (i mod 2); 7:3 split of
         the rest; R disjoint reference windows per client.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one stream (`name`) of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, name))
    return g


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of one client's parameters, in the port's names and
    layouts (HWIO convolutions, TIO for the TCN, (in, out) dense)."""
    kind, k = cfg["kind"], cfg["kernel_size"]
    cin, classes = cfg["input_shape"][-1], cfg["num_classes"]
    if kind == "cnn":
        h0, h1 = cfg["hidden"]
        h, w = cfg["input_shape"][:2]
        flat = (h // 4) * (w // 4) * h1
        return [("conv1", (k, k, cin, h0)), ("b1", (h0,)),
                ("conv2", (k, k, h0, h1)), ("b2", (h1,)),
                ("fc1", (flat, cfg["dense"])), ("bf1", (cfg["dense"],)),
                ("fc2", (cfg["dense"], classes)), ("bf2", (classes,))]
    if kind == "tcn":
        out, ch_in = [], cin
        for i, ch in enumerate(cfg["hidden"]):
            out += [(f"blocks.{i}.conv", (k, ch_in, ch)),
                    (f"blocks.{i}.b", (ch,))]
            if ch_in != ch:
                out.append((f"blocks.{i}.res", (ch_in, ch)))
            ch_in = ch
        return out + [("fc", (ch_in, classes)), ("bf", (classes,))]
    raise ValueError(f"unknown model kind {kind!r}")


def param_count(cfg: Dict) -> int:
    return sum(math.prod(s) for _, s in param_shapes(cfg))


def init_std(name: str, shape) -> float:
    """The port's initial scale: biases 0, convolutions 0.1, the rest
    fan-in ** -0.5 (of a truncated normal on [-2, 2])."""
    if len(shape) == 1:
        return 0.0
    if name.rsplit(".", 1)[-1].startswith("conv"):
        return 0.1
    return shape[-2] ** -0.5


def make_weights(cfg: Dict, m: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The M clients' initial weights, {name: (M, ...)} f32: one truncated
    normal draw of (M, P) on `device`, cut into leaves and scaled."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.empty((m, total), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(seed, "weights", device))
    out, p0 = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = (flat[:, p0:p0 + n] * init_std(name, shape)).reshape(
            (m,) + tuple(shape))
        p0 += n
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _mnist_templates(classes: int, side: int, device) -> torch.Tensor:
    """(classes, side, side): six Gaussian blobs per class, normalised to
    a maximum of 1, fixed for every seed (as the numpy generator's)."""
    g = torch.Generator()
    g.manual_seed(1000)
    grid = torch.arange(side, dtype=torch.float64) / side
    yy, xx = grid[:, None], grid[None, :]
    out = []
    for _ in range(classes):
        t = torch.zeros((side, side), dtype=torch.float64)
        for cx, cy, s in torch.rand((6, 3), generator=g, dtype=torch.float64):
            s = 0.05 + 0.1 * s
            t += torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2))
        out.append(t / t.max())
    return torch.stack(out).to(device=device, dtype=torch.float32)


def make_mnist(data: Dict, m: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    classes, side = data["classes"], data["side"]
    n_train = int(data["train_frac"] * data["per_client"])
    r, shards = data["ref_per_client"], data["shards"]
    g = generator(seed, "data", device)
    tmpl = _mnist_templates(classes, side, device)
    # each client sees `present` classes; each shard misses one of them
    present = torch.rand((m, classes), generator=g,
                         device=device).argsort(1)[:, :data["present"]]
    removed = torch.randint(0, data["present"], (m, shards), generator=g,
                            device=device)
    per_shard = data["per_client"] // shards
    kept_pos = torch.randint(0, data["present"] - 1, (m, shards, per_shard),
                             generator=g, device=device)
    kept_pos = kept_pos + (kept_pos >= removed[:, :, None]).to(kept_pos.dtype)
    y_all = torch.gather(present, 1, kept_pos.reshape(m, -1))
    # the 7:3 split of the shuffled examples; the train part is kept
    order = torch.rand(y_all.shape, generator=g, device=device).argsort(1)
    y = torch.gather(y_all, 1, order[:, :n_train])
    noise = math.hypot(data["noise_ref"], data["noise"] - data["noise_ref"])
    x = tmpl[y] + noise * torch.randn((m, n_train, side, side), generator=g,
                                      device=device)
    cluster = torch.arange(m, device=device) % data["clusters"]
    shift = (classes // data["clusters"]) * cluster
    y_ref_raw = torch.randint(0, classes, (m, r), generator=g, device=device)
    x_ref = tmpl[y_ref_raw] + data["noise_ref"] * torch.randn(
        (m, r, side, side), generator=g, device=device)
    return {"x_train": x[..., None],
            "y_train": ((y + shift[:, None]) % classes).to(torch.int32),
            "x_ref": x_ref[..., None],
            "y_ref": ((y_ref_raw + shift[:, None]) % classes).to(torch.int32)}


def make_timeseries(data: Dict, m: int, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    classes, length = data["classes"], data["length"]
    per, r = data["per_subject"], data["ref_per_client"]
    g = generator(seed, "data", device)
    t = torch.arange(length, device=device) / length
    sig = 0.3 * torch.randn((m, 1, 1), generator=g, device=device)
    y = torch.randint(0, classes, (m, per), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((m, per, 1), generator=g, device=device)
    freq = 3.0 + 4.0 * y[..., None]
    x = torch.sin(2 * math.pi * freq * t + phase)
    x = x + 0.3 * torch.sin(2 * math.pi * 1.5 * t)
    x = (1.0 + sig) * x + data["noise"] * torch.randn(
        (m, per, length), generator=g, device=device)
    # sliding windows: `windows` starts, each zero-padded to the length
    w = int(length * data["window_frac"])
    starts = torch.linspace(0, length - w, data["windows"]).long().tolist()
    xs = [torch.nn.functional.pad(x[:, :, s:s + w], (0, length - w))
          for s in starts]
    x = torch.cat(xs, 1)                                  # (M, per*W, T)
    y = y.repeat(1, len(starts))
    n = x.shape[1]
    cut = int(data["repo_frac"] * n)
    order = torch.rand((m, n), generator=g, device=device).argsort(1)
    repo, loc = order[:, :cut], order[:, cut:]
    shift = torch.arange(m, device=device) % data["clusters"]
    n_train = int(data["train_frac"] * (n - cut))
    split = torch.rand((m, n - cut), generator=g, device=device).argsort(1)
    tr = torch.gather(loc, 1, split[:, :n_train])
    x_tr = torch.gather(x, 1, tr[..., None].expand(-1, -1, length))
    y_tr = (torch.gather(y, 1, tr) + shift[:, None]) % classes
    # the shared pool: every subject's repo windows; disjoint R per client
    pool_x = torch.gather(x, 1, repo[..., None].expand(-1, -1, length))
    pool_x, pool_y = pool_x.reshape(m * cut, length), \
        torch.gather(y, 1, repo).reshape(m * cut)
    pick = torch.randperm(m * cut, generator=g, device=device)[:m * r]
    x_ref = pool_x[pick].reshape(m, r, length)
    y_ref = (pool_y[pick].reshape(m, r) + shift[:, None]) % classes
    return {"x_train": x_tr[..., None], "y_train": y_tr.to(torch.int32),
            "x_ref": x_ref[..., None], "y_ref": y_ref.to(torch.int32)}


GENERATORS = {"mnist": make_mnist, "timeseries": make_timeseries}


def make_data(cfg: Dict, m: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The federation's stacked data: x_train (M, n, ...), y_train (M, n)
    int32, x_ref (M, R, ...), y_ref (M, R) int32, on `device`."""
    data = cfg["data"]
    return GENERATORS[data["generator"]](data, m, seed, device)

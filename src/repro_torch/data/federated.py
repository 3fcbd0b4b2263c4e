"""The PyTorch port's own copy of the federated data pipeline (numpy
only; `tests/test_torch_protocol.py` holds it array-for-array equal to
the JAX package's for the same seed).

Federated data pipeline with the paper's exact partition statistics
(WPFed §4.3), over synthetic stand-in datasets (the repro=2 data gate:
MNIST / PhysioNet A-ECG / Sleep-EEG are not available offline — see
DESIGN.md §2).

Synthetic generators produce class-conditional data with learnable
structure so collaborative effects are measurable:
  - "mnist":   28x28x1 images, 10 classes = blurred class-template +
               per-client style shift + noise.
  - "aecg":    60-dim RR-interval sequences, 2 classes (apnea events as
               oscillation bursts), per-patient baseline drift.
  - "seeg":    100-dim EEG windows, 3 sleep stages as band-limited
               oscillations with per-subject amplitude signatures.

Partitions:
  - mnist: 20 shards -> 2 per client x 10 clients, one digit class
           removed per shard (non-IID label skew).
  - aecg / seeg: one client per subject (35 / 40), sliding-window
           augmentation, per-subject distribution shift.
  - reference repository: mnist -> held-out test pool; aecg/seeg -> 20%
           of data pooled across subjects; each client samples a
           disjoint subset as its personal reference set.
  - local train/test split 7:3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class ClientData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    x_ref: np.ndarray
    y_ref: np.ndarray


@dataclass
class FederatedDataset:
    name: str
    clients: list          # list[ClientData]
    num_classes: int
    input_shape: Tuple[int, ...]
    shared_ref_x: np.ndarray = None   # common public set (FedMD baseline)
    shared_ref_y: np.ndarray = None

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def stacked(self) -> Dict[str, np.ndarray]:
        """Stack per-client arrays (all clients have equal sizes) for
        vmap-based protocol simulation: dict of (M, n, ...) arrays."""
        f = lambda attr: np.stack([getattr(c, attr) for c in self.clients])
        return {k: f(k) for k in
                ("x_train", "y_train", "x_test", "y_test", "x_ref", "y_ref")}


# ---------------------------------------------------------------------------
# synthetic generators
# ---------------------------------------------------------------------------
def _mnist_like(rng, n, num_classes=10, side=28):
    """Class templates: smoothed random blobs; samples add noise+shift."""
    yy, xx = np.mgrid[0:side, 0:side] / side
    templates = []
    for c in range(num_classes):
        r = np.random.RandomState(1000 + c)
        t = np.zeros((side, side))
        for _ in range(6):
            cx, cy, s = r.rand(), r.rand(), 0.05 + 0.1 * r.rand()
            t += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2))
        templates.append(t / t.max())
    templates = np.stack(templates)
    y = rng.randint(0, num_classes, n)
    x = templates[y] + 0.35 * rng.randn(n, side, side)
    return x[..., None].astype(np.float32), y.astype(np.int32)


def _timeseries_like(rng, n, length, num_classes, subject_sig=0.0):
    """Band-limited oscillations; class = dominant frequency band."""
    t = np.arange(length) / length
    y = rng.randint(0, num_classes, n)
    freqs = 3.0 + 4.0 * y[:, None]                       # class frequency
    phase = 2 * np.pi * rng.rand(n, 1)
    x = np.sin(2 * np.pi * freqs * t[None, :] + phase)
    x += 0.3 * np.sin(2 * np.pi * 1.5 * t[None, :])      # common rhythm
    x = (1.0 + subject_sig) * x + 0.4 * rng.randn(n, length)
    return x[..., None].astype(np.float32), y.astype(np.int32)


def _sliding_window(x, y, window_frac=0.8, n_windows=3, rng=None):
    """Paper §4.3: sliding-window augmentation for A-ECG / S-EEG."""
    length = x.shape[1]
    w = int(length * window_frac)
    outs_x, outs_y = [], []
    for s in np.linspace(0, length - w, n_windows).astype(int):
        seg = x[:, s:s + w]
        pad = np.zeros((x.shape[0], length - w, x.shape[2]), x.dtype)
        outs_x.append(np.concatenate([seg, pad], axis=1))
        outs_y.append(y)
    return np.concatenate(outs_x), np.concatenate(outs_y)


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------
def _split_7_3(rng, x, y):
    idx = rng.permutation(len(x))
    cut = int(0.7 * len(x))
    tr, te = idx[:cut], idx[cut:]
    return x[tr], y[tr], x[te], y[te]


def make_mnist_federated(num_clients=10, per_client=400, ref_per_client=64,
                         seed=0, noise=0.55,
                         num_clusters=2) -> FederatedDataset:
    """10 clients x 2 shards; each shard has one digit class removed
    (paper §4.3 label skew), PLUS a personalization structure the paper's
    per-subject datasets have implicitly: clients belong to clusters with
    conflicting label semantics (cluster c relabels y -> (y + 5c) mod 10).
    Distilling from the wrong cluster is then actively harmful, so
    neighbor *selection* — the paper's contribution — carries signal.
    Reference labels follow each client's own mapping (the reference set
    is personal; only features are ever shared, §3.1)."""
    rng = np.random.RandomState(seed)
    pool_x, pool_y = _mnist_like(rng, num_clients * per_client * 3)
    pool_x += (noise - 0.35) * rng.randn(*pool_x.shape).astype(np.float32)
    ref_x, ref_y = _mnist_like(rng, 10_000)               # test set = repo
    shard_size = per_client
    clients = []
    ref_perm = rng.permutation(len(ref_x))

    def remap(y, cluster):
        return ((y + 5 * cluster) % 10).astype(np.int32)

    for i in range(num_clients):
        cluster = i % num_clusters
        # label skew: the client only ever SEES a subset of classes
        # (paper: one digit removed per shard; scarce-data regime makes
        # the skew stronger so neighbor knowledge is complementary)
        present = rng.choice(10, size=5, replace=False)
        xs, ys = [], []
        for shard in range(2):
            removed = int(rng.choice(present))            # per-shard removal
            keep_classes = np.setdiff1d(present, [removed])
            cand = np.where(np.isin(pool_y, keep_classes))[0]
            take = rng.choice(cand, shard_size // 2, replace=False)
            xs.append(pool_x[take])
            ys.append(remap(pool_y[take], cluster))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        xtr, ytr, xte, yte = _split_7_3(rng, x, y)
        rsl = ref_perm[i * ref_per_client:(i + 1) * ref_per_client]
        clients.append(ClientData(xtr, ytr, xte, yte, ref_x[rsl],
                                  remap(ref_y[rsl], cluster)))
    shared = ref_perm[num_clients * ref_per_client:
                      (num_clients + 1) * ref_per_client]
    return FederatedDataset("mnist", clients, 10, (28, 28, 1),
                            ref_x[shared], ref_y[shared])


def _make_subject_federated(name, num_clients, length, num_classes,
                            per_subject=120, ref_per_client=48, seed=0,
                            num_clusters=2):
    rng = np.random.RandomState(seed)
    subj_x, subj_y = [], []
    for s in range(num_clients):
        sig = 0.3 * rng.randn()                           # subject signature
        x, y = _timeseries_like(rng, per_subject, length, num_classes,
                                subject_sig=sig)
        x, y = _sliding_window(x, y, rng=rng)
        subj_x.append(x)
        subj_y.append(y)
    # 20% of each subject's data -> shared reference repository (labels
    # kept RAW; each client relabels its personal ref subset below)
    repo_x, repo_y, loc = [], [], []
    for x, y in zip(subj_x, subj_y):
        cut = int(0.2 * len(x))
        idx = rng.permutation(len(x))
        repo_x.append(x[idx[:cut]])
        repo_y.append(y[idx[:cut]])
        loc.append((x[idx[cut:]], y[idx[cut:]]))
    repo_x = np.concatenate(repo_x)
    repo_y = np.concatenate(repo_y)
    # keep per-client reference subsets disjoint even for small repos
    # (num_clients personal sets + 1 shared set must fit)
    ref_per_client = min(ref_per_client, len(repo_x) // (num_clients + 1))
    perm = rng.permutation(len(repo_x))
    clients = []
    for i, (x, y) in enumerate(loc):
        # cohort structure: clusters with cyclically-shifted label
        # semantics (see make_mnist_federated) — personalized selection
        # must find same-cohort subjects.
        shift = i % num_clusters
        y = ((y + shift) % num_classes).astype(np.int32)
        xtr, ytr, xte, yte = _split_7_3(rng, x, y)
        rsl = perm[i * ref_per_client:(i + 1) * ref_per_client]
        ref_y = ((repo_y[rsl] + shift) % num_classes).astype(np.int32)
        clients.append(ClientData(xtr, ytr, xte, yte, repo_x[rsl], ref_y))
    shared = perm[num_clients * ref_per_client:
                  (num_clients + 1) * ref_per_client]
    return FederatedDataset(name, clients, num_classes, (length, 1),
                            repo_x[shared], repo_y[shared])


def make_aecg_federated(num_clients=35, seed=0,
                        per_subject=120) -> FederatedDataset:
    return _make_subject_federated("aecg", num_clients, 60, 2, seed=seed,
                                   per_subject=per_subject)


def make_seeg_federated(num_clients=40, seed=0,
                        per_subject=120) -> FederatedDataset:
    return _make_subject_federated("seeg", num_clients, 100, 3, seed=seed,
                                   per_subject=per_subject)


DATASETS = {"mnist": make_mnist_federated,
            "aecg": make_aecg_federated,
            "seeg": make_seeg_federated}

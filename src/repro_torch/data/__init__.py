"""Synthetic federated datasets (a copy of `repro.data.federated`)."""
from repro_torch.data.federated import DATASETS, FederatedDataset  # noqa: F401

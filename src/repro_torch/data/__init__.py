"""Synthetic datasets (copies of `repro.data.federated` and
`repro.data.synthetic`)."""
from repro_torch.data.federated import DATASETS, FederatedDataset  # noqa: F401
from repro_torch.data.synthetic import TokenStream, modality_stub  # noqa: F401

"""Seeded-bad fixture: `host-sync` — host reads of device values with no
justification. The exemption in `checked` covers its own line only: the
read on the next line is still a finding."""
import torch


def mean_loss(losses: torch.Tensor) -> float:
    return float(losses.mean())        # BUG: waits for the device


def checked(values: torch.Tensor):
    total = values.sum().item()  # analysis: host-ok covers this line only
    return total, values.max().item()  # BUG: the exemption stops above

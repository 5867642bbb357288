"""The device the port's entry points run on unless the caller names one."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card. Without a card
    that raises: nothing falls back to the host unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless told otherwise; "
            "pass device='cpu' to run on the host")
    return torch.device("cuda")

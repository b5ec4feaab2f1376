"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never carries on on the CPU when no card is found."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when a CUDA device is asked for
    and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but no CUDA device is available")
    return dev


def check_module(module, device) -> None:
    """Raise unless `module`'s parameters live on `device`."""
    dev = resolve(device)
    got = next(module.parameters()).device
    if got.type != dev.type or (dev.index is not None and got != dev):
        raise ValueError(f"{type(module).__name__} lives on {got}, not on {dev}")

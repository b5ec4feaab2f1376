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

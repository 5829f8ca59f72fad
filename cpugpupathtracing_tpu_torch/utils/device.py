"""Device selection: every entry point of the port takes an explicit
`device` that defaults to the card.  Asking for the card where none is
present raises; nothing silently runs on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device`, with a CUDA device's index made
    explicit (so "cuda" and "cuda:0" compare equal)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

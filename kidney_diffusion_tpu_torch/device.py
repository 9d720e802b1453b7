"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device(device)`, refusing a CUDA device when there is no card.

    Entry points default to `"cuda"`; a caller without a card must ask for
    the CPU explicitly (`device="cpu"`), so that a run meant for the card
    never falls back to the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev

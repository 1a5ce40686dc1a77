"""Where the port's entry points run: the card, unless the caller names
another device (``device="cpu"`` for tests and tools). There is no silent
move to the CPU when no card is present."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA. Raises when CUDA is
    asked for and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ragmeup_tpu_torch runs on the GPU unless it is "
            "given device='cpu'")
    return dev

"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device, who: str = "BE") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.

    Raises when CUDA is asked for (or defaulted to) and no card is present:
    the CPU is used only when the caller names it.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device=cuda): no CUDA device is available; pass"
            " device='cpu' to run on the CPU"
        )
    return device

"""The one place that turns an entry point's ``device`` argument into a
``torch.device``."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means the card.  A CUDA device that is not there raises:
    no code path moves to the CPU because it found no GPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev

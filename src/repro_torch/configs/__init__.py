"""Config registry of the port: the paper's two CapsNets (the LM
architectures follow with the LM slice).

``get_config(arch_id)`` returns the full published config;
``reduced(cfg)`` returns a CPU-smoke-sized config of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

from repro_torch.configs import capsnet_fmnist, capsnet_mnist
from repro_torch.core.capsnet import CapsNetConfig

_MODULES = {
    "capsnet-mnist": capsnet_mnist,
    "capsnet-fmnist": capsnet_fmnist,
}

PAPER_ARCHS: List[str] = ["capsnet-mnist", "capsnet-fmnist"]


def list_archs() -> List[str]:
    return list(PAPER_ARCHS)


def get_config(arch_id: str):
    try:
        return _MODULES[arch_id].CONFIG
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; known: "
                         f"{list_archs()}") from None


def reduced(cfg) -> Any:
    """Shrink a config to CPU-smoke size, preserving its family."""
    if isinstance(cfg, CapsNetConfig):
        return dataclasses.replace(
            cfg, conv1_channels=16, caps_types=4, decoder_hidden=(32, 64))
    raise TypeError(f"reduced: unsupported config {type(cfg).__name__}")

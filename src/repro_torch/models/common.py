"""Parameter declaration and initialisation shared by the models.

Parameters are plain nested dicts of tensors, declared as a tree of
:class:`ParamDef` and initialised from one explicit ``torch.Generator``.
The port's init does not reproduce ``jax.random``'s bits (the parity tests
convert the reference's parameters instead); it keeps the distribution:
truncated normal at +-2 sigma with std ``1/sqrt(fan_in)``, zero biases.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

InitFn = Callable[[torch.Generator, Tuple[int, ...], torch.dtype], torch.Tensor]


def zeros_init() -> InitFn:
    def init(gen, shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    return init


def fanin_init(fan_in: Optional[int] = None) -> InitFn:
    def init(gen, shape, dtype):
        fi = fan_in if fan_in is not None else shape[0]
        std = 1.0 / math.sqrt(max(fi, 1))
        x = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        return (x * std).to(dtype)

    return init


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: InitFn

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def init_params(defs: Any, generator: torch.Generator, dtype: torch.dtype,
                device: Any = "cpu") -> Any:
    """Initialise a (nested dict) tree of ParamDefs into tensors.

    Values are drawn on the host from ``generator`` in the tree's key order
    (so one seed gives one model whatever the device) and then moved."""
    if isinstance(defs, ParamDef):
        return defs.init(generator, defs.shape, dtype).to(device)
    return {k: init_params(v, generator, dtype, device)
            for k, v in defs.items()}

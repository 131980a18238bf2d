"""Shared helpers of the ``test_torch_*`` parity tests.

Inputs are made with numpy from a seed and handed to both packages: the
reference (``repro``, JAX on the CPU, Pallas kernels in interpret mode) and
the port (``repro_torch``, CPU tensors, kernels' plain versions).  Parameters
are initialised by the reference and carried over leaf by leaf with
``repro_torch.convert``.

``PortToyEngine`` is ``engine_testlib.ToyEngine`` rebuilt on the port's
``EngineCore`` (same hooks, same instrumentation), so the scheduler contract
can be re-run against the port's schedulers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import capsnet as ref_capsnet
from repro_torch import convert
from repro_torch.core import capsnet as port_capsnet
from repro_torch.serving.core import EngineCore, SlotTask


def rand(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def to_jax(x: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def to_torch(x: np.ndarray, dtype: str = "float32") -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(getattr(torch, dtype))


def f32(x) -> np.ndarray:
    """Any array or tensor (bf16 included) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


SMALL = dict(conv1_channels=8, caps_types=4, decoder_hidden=(32, 64))


def small_cfgs(**kw):
    """The same small CapsNet config for both packages (routing unset)."""
    base = dict(SMALL)
    base.update(kw)
    return (ref_capsnet.CapsNetConfig(**base),
            port_capsnet.CapsNetConfig(**base))


def paired_params(ref_cfg, seed: int = 0):
    """Reference-initialised params and their leaf-by-leaf torch copy."""
    ref_params = ref_capsnet.init(ref_cfg, jax.random.key(seed))
    as_numpy = jax.tree.map(np.asarray, ref_params)
    return ref_params, convert.params_from_numpy(as_numpy, "cpu")


def images(seed: int, n: int, cfg) -> np.ndarray:
    return np.random.RandomState(seed).rand(
        n, cfg.image_hw, cfg.image_hw, cfg.in_channels).astype(np.float32)


# ---------------------------------------------------------------------------
# Toy engine on the port's EngineCore
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ToyRequest:
    """``n_tasks`` parallel slot tasks, each needing ``steps`` ticks."""

    n_tasks: int = 1
    steps: int = 1
    rid: Optional[int] = None
    stream: bool = False
    priority: int = 0                 # 0 = most urgent


@dataclasses.dataclass
class ToyCompletion:
    rid: int
    items: int                        # tasks served
    latency_s: float


class PortToyEngine(EngineCore):
    """Counting engine: ``_step`` decrements each active task's countdown."""

    def __init__(self, capacity: int = 4, scheduler=None, clock=None):
        super().__init__(capacity=capacity, scheduler=scheduler,
                         clock=clock or time.perf_counter)
        self.max_occupied = 0
        self.max_batch = 0
        self.admitted_order: List[int] = []

    def _expand(self, request: ToyRequest
                ) -> Tuple[List[SlotTask], Dict[str, Any]]:
        if request.n_tasks < 0 or request.steps < 1:
            raise ValueError("bad toy request")
        return [SlotTask(payload=request.steps)
                for _ in range(request.n_tasks)], {}

    def _admit(self, new):
        for _, task in new:
            task.state.setdefault("left", task.payload)
            self.admitted_order.append(task.rid)
        return [], 0

    def _step(self, active, n_batch):
        self.max_occupied = max(self.max_occupied, len(active))
        self.max_batch = max(self.max_batch, n_batch)
        finished = []
        for s, task in active:
            task.state["left"] -= 1
            self._emit(task.rid, ("step", task.state["left"]))
            if task.state["left"] <= 0:
                finished.append(s)
        return finished, len(active)

    def _request_class(self, request: ToyRequest) -> str:
        return f"toy/t{request.n_tasks}"

    def _finalize(self, entry, latency_s: float) -> ToyCompletion:
        return ToyCompletion(rid=entry.request.rid, items=len(entry.tasks),
                             latency_s=latency_s)

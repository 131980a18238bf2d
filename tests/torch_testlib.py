"""Shared helpers of the ``test_torch_*`` parity tests.

Inputs are made with numpy from a seed and handed to both packages: the
reference (``repro``, JAX on the CPU, Pallas kernels in interpret mode) and
the port (``repro_torch``, CPU tensors, kernels' plain versions).  Parameters
are initialised by the reference and carried over leaf by leaf with
``repro_torch.convert``.

``PortToyEngine`` is ``engine_testlib.ToyEngine`` rebuilt on the port's
``EngineCore`` (same hooks, same instrumentation), so the scheduler contract
can be re-run against the port's schedulers.  ``PortToyPrefillEngine`` /
``PortToyDecodeEngine`` / ``PortFlakyTransport`` are the disaggregated pair
and the fault-injecting transport of ``engine_testlib`` on the port's
``repro_torch.serving`` types: prefill completes every request with a
``CacheHandoff`` whose rows (tensors) encode the handoff identity
(:func:`port_toy_rows`), and decode verifies them bit-exactly on admission.
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
from repro_torch.serving.disagg import CacheHandoff, HandoffRequest
from repro_torch.serving.transport import InProcessTransport, TransportError


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


# ---------------------------------------------------------------------------
# Disaggregated toy pair and fault-injecting transport on the port's types
# ---------------------------------------------------------------------------


def port_toy_rows(rid: int, steps: int) -> Dict[str, torch.Tensor]:
    """Deterministic cache-row payload derived from the handoff identity
    (mixed shapes and dtypes, like a real cache tree)."""
    return {"state": torch.full((2, 3), float(rid * 1000 + steps)),
            "tag": torch.tensor([rid, steps], dtype=torch.int32)}


class PortToyPrefillEngine(PortToyEngine):
    """``engine_testlib.ToyPrefillEngine`` on the port: slots live one
    admission, the engine never streams, and every request completes at
    prefill with a ``CacheHandoff`` (``family="toy"``, ``left`` = the
    request's ``steps``, rows from :func:`port_toy_rows`); zero-task
    requests complete with the identity ``ToyCompletion``."""

    def _wants_stream(self, request: ToyRequest) -> bool:
        return False                  # streaming starts on the decode side

    def _expand(self, request: ToyRequest
                ) -> Tuple[List[SlotTask], Dict[str, Any]]:
        tasks, extra = super()._expand(request)
        return [SlotTask(payload=1) for _ in tasks[:1]], extra

    def _finalize(self, entry, latency_s: float):
        if not entry.tasks:
            return super()._finalize(entry, latency_s)
        req = entry.request
        return CacheHandoff(
            rid=req.rid, request=req, family="toy", arch_id="toy",
            max_len=0, rows=port_toy_rows(req.rid, req.steps), tok=0, pos=0,
            out=[], left=int(req.steps), stream=bool(req.stream),
            cls=self._request_class(req))


class PortToyDecodeEngine(PortToyEngine):
    """Decode half of the toy pair: verifies a handoff's rows bit-exactly
    against :func:`port_toy_rows` (keys, shapes, dtypes, values), raising
    ``ValueError`` on any mismatch, then counts down ``left`` ticks."""

    def _expand(self, request: Any
                ) -> Tuple[List[SlotTask], Dict[str, Any]]:
        if not isinstance(request, HandoffRequest):
            return super()._expand(request)
        h = request.handoff
        if h.family != "toy":
            raise ValueError(
                f"toy decode engine got family {h.family!r} handoff")
        if not h.done:
            want = port_toy_rows(h.rid, h.left)
            got = h.rows if isinstance(h.rows, dict) else {}
            for key, w in want.items():
                g = got.get(key)
                if (not isinstance(g, torch.Tensor) or g.shape != w.shape
                        or g.dtype != w.dtype or not torch.equal(g, w)):
                    raise ValueError(
                        f"handoff rid={h.rid}: rows leaf {key!r} corrupted "
                        f"in transit")
        return [SlotTask(payload=max(int(h.left), 1))], {}

    def _request_class(self, request: Any) -> str:
        if isinstance(request, HandoffRequest):
            return request.handoff.cls
        return super()._request_class(request)


class PortFlakyTransport(InProcessTransport):
    """In-process delivery with scripted synthetic delays and injected
    failures: ``fail_on`` holds 0-based delivery-attempt indices that raise
    ``TransportError``; ``delays`` cycle into the recorded ``pass`` leg as
    synthetic seconds (recorded, never slept)."""

    name = "flaky"
    LEGS = ("pass",)

    def __init__(self, delays=(), fail_on=(), **kwargs):
        super().__init__(**kwargs)
        self.delays = list(delays)
        self.fail_on = set(fail_on)
        self.calls = 0                              # guarded-by: _lock

    def _move(self, rows: Any, target: Any):
        with self._lock:
            i = self.calls
            self.calls += 1
        if i in self.fail_on:
            raise TransportError(f"injected failure on delivery {i}")
        delay = float(self.delays[i % len(self.delays)]) if self.delays \
            else 0.0
        return rows, {"pass": delay}, None

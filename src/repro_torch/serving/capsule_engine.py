"""CapsuleEngine: batched CapsNet image serving over the shared EngineCore.

The paper's throughput story is a *served* workload, not a bare forward
loop.  This adapter serves image-classification requests through one
fixed-shape forward per tick:

* **Request expansion** — requests carry a ragged number of frames; each
  frame becomes one slot task, so frames from different requests share a
  tick's batch (slot recycling).
* **Scheduler-shaped batches** — every tick packs the occupied slots into
  a batch whose size the scheduler chose: the FIFO scheduler always runs
  the one full-capacity shape (zero-padding the tail), the SLO scheduler
  shrinks/grows power-of-two buckets against a p95 target.
* **Async admission** — ``submit()`` is thread-safe and non-blocking;
  frames submitted while a tick is in flight join the next tick.
* **FPS / latency stats** — cumulative frames, ticks, padding waste and
  wall-clock, plus per-request latency from submit to completion.

A tick on the card is: numpy batch -> pinned host tensor -> asynchronous
copy to the device -> ``deployed.forward`` (two convolutions, one einsum,
one launch of the routing kernel) -> copy of the lengths back to the host,
which is also the tick's synchronisation.

``engine = deployed.serve(scheduler=...)`` (on a
:class:`repro_torch.deploy.DeployedCapsNet`) is the canonical way in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.core import EngineCore, SlotTask
from repro_torch.serving.schedulers import Scheduler, pow2_bucket


@dataclasses.dataclass
class ImageRequest:
    """A batch-of-frames classification request (ragged ``images`` count).

    ``rid=None`` lets the engine assign the next free id at submit time.
    ``stream=True`` emits one :class:`repro_torch.serving.StreamEvent` per
    classified frame (``item=(frame_index, class_id)``) on the
    ``poll(stream=True)`` channel as ticks complete, instead of waiting
    for the whole request.
    """

    images: np.ndarray                # (n_frames, H, W, C)
    rid: Optional[int] = None
    stream: bool = False


@dataclasses.dataclass
class ImageCompletion:
    rid: int
    classes: np.ndarray               # (n_frames,) int32 predictions
    lengths: np.ndarray               # (n_frames, n_classes) capsule lengths
    latency_s: float                  # submit -> completion wall-clock


class CapsuleEngine(EngineCore):
    """Fixed-shape micro-batched inference over a :class:`DeployedCapsNet`.

    ``deployed`` is any object with ``cfg`` (a CapsNetConfig), ``device``
    and ``forward(images) -> lengths`` — in practice the artifact returned
    by ``FastCapsPipeline.compile``.  ``device=None`` means the card (and
    raises when there is none); it must be the device the artifact is on.  ``batch_size`` is the engine capacity (max frames per tick);
    the scheduler decides how much of it each tick actually uses.
    """

    def __init__(self, deployed: Any, batch_size: int = 32,
                 scheduler: Optional[Scheduler] = None,
                 clock=time.perf_counter,
                 kernel_tune: Optional[bool] = None,
                 device: Any = None):
        self.deployed = deployed
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if self.device.type != torch.device(deployed.device).type:
            raise ValueError(
                f"engine device {self.device} differs from the deployed "
                f"model's {deployed.device}")
        cfg = deployed.cfg
        self._frame_shape = (cfg.image_hw, cfg.image_hw, cfg.in_channels)
        self._n_classes = cfg.n_classes
        super().__init__(capacity=batch_size, scheduler=scheduler,
                         clock=clock, kernel_tune=kernel_tune)

    # -- workload hooks ----------------------------------------------------

    def _expand(self, request: ImageRequest
                ) -> Tuple[List[SlotTask], Dict[str, Any]]:
        imgs = np.asarray(request.images, np.float32)
        if imgs.ndim != 4 or imgs.shape[1:] != self._frame_shape:
            raise ValueError(
                f"request images must be (n,) + {self._frame_shape}, got "
                f"{imgs.shape}")
        request.images = imgs
        n = imgs.shape[0]
        state = {"lengths": np.zeros((n, self._n_classes), np.float32)}
        return [SlotTask(payload=(k, imgs[k])) for k in range(n)], state

    def forward_host(self, batch: np.ndarray) -> np.ndarray:
        """One forward of a host batch; returns the lengths on the host.
        The copy back waits for the device, so no other synchronisation
        is needed."""
        x = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        lengths = self.deployed.forward(self.scheduler.place(x))
        return lengths.cpu().numpy()

    def _step(self, active: List[Tuple[int, SlotTask]], n_batch: int
              ) -> Tuple[List[int], int]:
        batch = np.zeros((n_batch,) + self._frame_shape, np.float32)
        for i, (_, task) in enumerate(active):
            batch[i] = task.payload[1]
        lengths = self.forward_host(batch)
        for i, (_, task) in enumerate(active):
            k = task.payload[0]
            self._requests[task.rid].state["lengths"][k] = lengths[i]
            self._emit(task.rid, (k, int(np.argmax(lengths[i]))))
        return [s for s, _ in active], len(active)

    def _request_class(self, request: ImageRequest) -> str:
        """Latency histogram key: frame counts bucketed to powers of two
        (``"image/f4"`` = requests carrying 3-4 frames)."""
        return f"image/f{pow2_bucket(len(request.images), self.capacity)}"

    def _finalize(self, entry, latency_s: float) -> ImageCompletion:
        buf = entry.state["lengths"]
        return ImageCompletion(
            rid=entry.request.rid,
            classes=np.argmax(buf, -1).astype(np.int32),
            lengths=buf,
            latency_s=latency_s)

    def _warmup(self) -> None:
        # run every batch shape the scheduler can emit, so no tick (and no
        # SLO latency observation) pays a first-run cost; on the card the
        # first of these runs also builds and loads the kernels
        for n in self.scheduler.shapes(self.capacity):
            self.forward_host(
                np.zeros((n,) + self._frame_shape, np.float32))

    def _pretune(self) -> None:
        # bind-time kernel tuning: measure the routing kernel's launch
        # geometry (cluster size i_splits x threads per block) for every
        # u_hat shape the scheduler's batch shapes imply, so every later
        # dispatch finds the cache populated
        spec = getattr(self.deployed, "spec", None)
        if spec is None or spec.mode != "cuda" or self.device.type != "cuda":
            return
        from repro_torch.kernels import tuning as ktuning
        from repro_torch.kernels.registry import registry as kernel_registry

        kspec = kernel_registry.get("fused_routing")
        cfg = self.deployed.cfg
        cache = ktuning.default_cache()
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        for n in self.scheduler.shapes(self.capacity):
            u_hat = (torch.randn(
                (n, cfg.n_primary_caps, cfg.n_classes, cfg.digit_dim),
                generator=gen) * 0.2).to(self.device)
            if cache.get(ktuning.cache_key_for(kspec, (u_hat,))) is None:
                ktuning.autotune(
                    kspec, (u_hat,),
                    {"n_iters": cfg.routing_iters,
                     "softmax_mode": spec.softmax}, cache=cache)

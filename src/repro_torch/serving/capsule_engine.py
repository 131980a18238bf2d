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
copy into the static input of the batch shape's CUDA graph -> replay of
``deployed.forward``'s graph (two convolutions, one einsum, one launch of
the routing kernel) -> copy of the lengths back to the host, which is
also the tick's synchronisation.  The warm-up captures the graph of
every batch shape the scheduler can emit, so no tick pays for a capture
(one that does excludes its seconds from the tick wall).

Under a :class:`repro_torch.serving.ShardedScheduler` each distinct
device of the mesh's batch axes holds one replica of the deployed model
(with graphs of its own);
a tick's padded frame batch is split by ``place()`` into one contiguous
block per device, every block's forward is launched before the first
copy back, and the lengths come back in frame order.

``engine = deployed.serve(scheduler=...)`` (on a
:class:`repro_torch.deploy.DeployedCapsNet`) is the canonical way in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import indexed, resolve_device
from repro_torch.serving.core import EngineCore, SlotTask
from repro_torch.serving.schedulers import (Scheduler, ShardedScheduler,
                                            pow2_bucket)


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
        sharded = isinstance(scheduler, ShardedScheduler)
        self.device = (resolve_device(scheduler.devices[0]) if sharded
                       else resolve_device(device))
        if self.device.type != torch.device(deployed.device).type:
            raise ValueError(
                f"engine device {self.device} differs from the deployed "
                f"model's {deployed.device}")
        cfg = deployed.cfg
        self._frame_shape = (cfg.image_hw, cfg.image_hw, cfg.in_channels)
        self._n_classes = cfg.n_classes
        super().__init__(capacity=batch_size, scheduler=scheduler,
                         clock=clock, kernel_tune=kernel_tune)
        # the model for each block of the batch axes: one replica per
        # distinct device, shared by the blocks on it
        self._replicas: List[Any] = []
        if sharded:
            by_device: Dict[torch.device, Any] = {}
            for dev in scheduler.devices:
                if dev not in by_device:
                    by_device[dev] = (
                        deployed if dev == indexed(deployed.device)
                        else dataclasses.replace(deployed, device=dev))
                self._replicas.append(by_device[dev])

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
        On the card the batch is pinned and staged straight into the
        static input of its shape's graph.  The copy back waits for the
        device, so no other synchronisation is needed.  Sharded: one
        forward per block on its device's replica, all launched before the
        first copy back."""
        x = torch.from_numpy(np.ascontiguousarray(batch))
        if self._replicas:
            # place() gives a block per device in order (or the whole
            # batch, on the first device, when it does not divide)
            outs = [self._replicas[k].forward(b)
                    for k, b in enumerate(self.scheduler.place(x))]
            return np.concatenate([o.cpu().numpy() for o in outs])
        if self.device.type == "cuda":
            x = x.pin_memory()
        lengths = self.deployed.forward(self.scheduler.place(x))
        return lengths.cpu().numpy()

    def graph_stats(self) -> Dict[str, float]:
        """The forward's graphs: captured, re-captured and replayed, eager
        runs and capture seconds, over every replica."""
        models = {id(m): m for m in [self.deployed] + self._replicas}
        out: Dict[str, float] = {}
        for m in models.values():
            for k, v in getattr(m, "graph_stats", dict)().items():
                out[k] = out.get(k, 0) + v
        return out

    def _step(self, active: List[Tuple[int, SlotTask]], n_batch: int
              ) -> Tuple[List[int], int]:
        batch = np.zeros((n_batch,) + self._frame_shape, np.float32)
        for i, (_, task) in enumerate(active):
            batch[i] = task.payload[1]
        captured_s = self.graph_stats().get("capture_s", 0.0)
        lengths = self.forward_host(batch)
        # a shape the warm-up did not capture: its capture is one-off work
        self._exclude_tick_time(
            self.graph_stats().get("capture_s", 0.0) - captured_s)
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
        # SLO latency observation) pays a first-run cost; on the card each
        # captures its shape's graph, and the first also builds and loads
        # the kernels
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

"""Pluggable tick schedulers for :class:`repro_torch.serving.EngineCore`.

A scheduler makes the four decisions the paper's throughput story hinges
on (CapsAcc / PIM-CapsNet: scheduling and data movement around the compute,
not the kernel alone):

  * **admission** — ``plan()``: how many slots may be occupied this tick
    (the *effective batch size*);
  * **shape** — ``quantize()``: the concrete compiled batch the workload
    pads to (a small, bounded set of shapes keeps warm-up finite);
  * **placement** — ``place()``: where the tick's batch lives (host, a
    single device, or — :class:`ShardedScheduler` — one contiguous block
    per device of a mesh);
  * **interleaving** — ``phase()``: whether a tick admits new work
    (prefill), steps the resident work (decode), or does both.  The
    default ``"mixed"`` keeps the legacy behaviour where prefill rides
    the admission tick.

The engine feeds back one :class:`~repro_torch.serving.core.TickRecord` per tick
through ``observe()`` so adaptive schedulers (the SLO controller) can close
the loop on measured latency.

Variants:

  * :class:`FIFOScheduler` — admit everything, always run the full
    fixed-shape batch (one executable; the shape-stability posture of the
    original drain-the-queue engines).
  * :class:`SLOBatchScheduler` — adapt the effective batch size to a
    target p95 tick latency: halve when the observed p95 overshoots the
    SLO, double back when a full window sits comfortably under it.
  * :class:`InterleavingScheduler` — dedicate whole ticks to prefill
    (admission) or decode (stepping) so a burst of long prompts cannot
    stretch the inter-token latency of the already-resident slots.
  * :class:`DisaggScheduler` — the phase policy of a
    disaggregated front-end, which adds a
    fourth tick kind: ``"handoff"`` (move finished prefills to a decode
    engine).  Plain engines have no handoff stage and coerce the answer
    to ``"mixed"``, so the scheduler is safe to bind anywhere.
  * :class:`PriorityScheduler` — priority classes with preemption: queued
    tasks admit in (priority, arrival) order, and when a higher-priority
    task is queued with no free slot the scheduler evicts the
    lowest-priority resident (the engine saves its resumable state and
    requeues it — lossless, see ``EngineCore._evict``).  Admission
    size/shape/placement delegate to an inner scheduler.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Optional

import numpy as np
import torch


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clipped to [1, cap]."""
    n = max(1, min(int(n), int(cap)))
    b = 1
    while b < n:
        b *= 2
    return min(b, int(cap))


@dataclasses.dataclass(frozen=True)
class TickRecord:
    """What the engine observed for one tick (scheduler feedback)."""

    n_active: int                  # real slot tasks stepped
    n_batch: int                   # compiled batch the workload ran
    wall_s: float                  # admit + step wall-clock


class Scheduler:
    """Base scheduler: admit to capacity, one full-capacity shape.

    ``bind(core)`` is called once by the engine; schedulers are stateful
    and must not be shared between live engines.  All hooks are invoked
    by the engine with its tick lock held by a single ticker thread, so
    implementations need no locking of their own; they must not call
    back into the engine.
    """

    capacity: int = 0

    def bind(self, core: Any) -> None:
        self.capacity = core.capacity

    def plan(self, n_queued: int, n_active: int) -> int:
        """Max slots that may be occupied this tick (effective batch)."""
        return self.capacity

    def phase(self, n_queued: int, n_active: int) -> str:
        """Tick interleaving policy: ``"mixed"`` (admit *and* step — the
        legacy behaviour where prefill rides the admission tick),
        ``"prefill"`` (admission/prefill only; resident slots idle one
        tick), ``"decode"`` (step only; the queue waits), or
        ``"handoff"`` (disaggregated front-ends only: move finished
        prefill state to a decode engine).  The engine coerces
        impossible answers (e.g. ``"decode"`` with no resident work, or
        ``"handoff"`` on an engine with no handoff stage) back to
        ``"mixed"`` so a scheduler can never stall it."""
        return "mixed"

    def quantize(self, n_active: int, capacity: int) -> int:
        """Concrete compiled batch size for ``n_active`` filled slots."""
        return capacity

    def shapes(self, capacity: int) -> tuple:
        """Every batch size ``quantize`` can emit (warmup compiles each,
        so no tick pays compile time inside the measured path)."""
        return (capacity,)

    def place(self, batch: Any) -> Any:
        """Device placement of a tick's batch array (default: leave it to
        the engine's own host-to-device copy)."""
        return batch

    def select(self, queue: Any) -> int:
        """Index into the engine's task queue of the next task to admit.
        The default 0 keeps admission strictly FIFO; a priority policy
        may reorder *across* classes but must stay FIFO within a class
        (the conformance suite pins starvation-freedom)."""
        return 0

    def preempt(self, queued: Any, residents: Any) -> tuple:
        """Slot ids to evict before this tick's admission.

        ``queued`` is the engine's task backlog (:class:`SlotTask`-like
        objects carrying ``priority``), ``residents`` the occupied
        ``(slot, task)`` pairs.  Evicted tasks are handed to the
        workload's ``_evict`` hook (which saves resumable state) and
        requeued at the *front* of the queue — never dropped.  Default:
        no preemption."""
        return ()

    def observe(self, record: TickRecord) -> None:
        pass


class FIFOScheduler(Scheduler):
    """Admit in arrival order up to capacity; always run the one
    full-capacity executable (maximum shape stability)."""


class SLOBatchScheduler(Scheduler):
    """Latency-SLO-aware effective batch size controller.

    Tracks a sliding window of per-tick wall-clock and compares its p95
    against ``target_p95_ms``:

      * p95 above target  -> halve the effective batch (fast back-off;
        acts as soon as ``min_samples`` ticks are in the window);
      * a *full* window at or below ``grow_frac * target`` -> double it
        (slow recovery, up to engine capacity).

    Tick shapes are power-of-two buckets of the effective batch, so the
    set of warmed-up shapes stays O(log capacity).
    """

    def __init__(self, target_p95_ms: float, window: int = 16,
                 min_samples: int = 4, grow_frac: float = 0.5,
                 initial_batch: Optional[int] = None):
        if target_p95_ms < 0:
            raise ValueError("target_p95_ms must be >= 0")
        self.target_p95_ms = float(target_p95_ms)
        self.window = int(window)
        self.min_samples = max(1, int(min_samples))
        self.grow_frac = float(grow_frac)
        self._initial = initial_batch
        self._batch = initial_batch or 1
        self._lat: Deque[float] = deque(maxlen=self.window)

    @property
    def effective_batch(self) -> int:
        return self._batch

    def bind(self, core: Any) -> None:
        super().bind(core)
        self._batch = min(self._initial or self.capacity, self.capacity)
        self._lat.clear()

    def plan(self, n_queued: int, n_active: int) -> int:
        return self._batch

    def quantize(self, n_active: int, capacity: int) -> int:
        return pow2_bucket(n_active, capacity)

    def shapes(self, capacity: int) -> tuple:
        out, b = [], 1
        while b < capacity:
            out.append(b)
            b *= 2
        return tuple(out) + (capacity,)

    def observe(self, record: TickRecord) -> None:
        if record.n_batch <= 0:
            return
        self._lat.append(record.wall_s * 1e3)
        if len(self._lat) < self.min_samples:
            return
        p95 = float(np.percentile(np.asarray(self._lat), 95))
        if p95 > self.target_p95_ms and self._batch > 1:
            self._batch = max(1, self._batch // 2)
            self._lat.clear()
        elif (len(self._lat) == self.window
              and p95 <= self.grow_frac * self.target_p95_ms
              and self._batch < self.capacity):
            self._batch = min(self.capacity, self._batch * 2)
            self._lat.clear()


class InterleavingScheduler(Scheduler):
    """Prefill/decode tick interleaving (disaggregated-in-time serving).

    The mixed tick couples two very different costs: a newly admitted
    slot's prefill is O(prompt length) while a resident slot's decode
    step is O(1) token.  Under the legacy ``"mixed"`` policy a burst of
    long prompts rides the same tick as everyone else's decode step and
    stretches inter-token latency for the whole batch.  This scheduler
    dedicates whole ticks instead:

      * queue non-empty and a slot free -> a **prefill** tick (admit and
        prefill the newcomers; residents idle exactly one tick);
      * otherwise -> a **decode** tick (step residents; the queue waits
        for the next free slot).

    ``decode_ratio`` bounds how often prefill may steal a tick: after a
    prefill tick, at least ``decode_ratio`` decode ticks run before the
    next admission (0 = admit whenever possible).  Admission size and
    shape delegate to ``inner``, so SLO batching composes underneath.
    """

    def __init__(self, inner: Optional[Scheduler] = None,
                 decode_ratio: int = 0):
        if decode_ratio < 0:
            raise ValueError("decode_ratio must be >= 0")
        self.inner = inner or FIFOScheduler()
        self.decode_ratio = int(decode_ratio)
        self._since_prefill = 0

    def bind(self, core: Any) -> None:
        super().bind(core)
        self.inner.bind(core)
        self._since_prefill = self.decode_ratio   # first tick may admit

    def plan(self, n_queued: int, n_active: int) -> int:
        return self.inner.plan(n_queued, n_active)

    def quantize(self, n_active: int, capacity: int) -> int:
        return self.inner.quantize(n_active, capacity)

    def shapes(self, capacity: int) -> tuple:
        return self.inner.shapes(capacity)

    def place(self, batch: Any) -> Any:
        return self.inner.place(batch)

    def phase(self, n_queued: int, n_active: int) -> str:
        if n_active == 0 and n_queued > 0:
            # idle engine: admit now (answering "decode" here would be
            # coerced to "mixed" by the engine, silently bypassing the
            # decode_ratio promise and leaving the counter stale)
            self._since_prefill = 0
            return "prefill"
        free = self.capacity - n_active
        may_admit = (n_queued > 0 and free > 0
                     and self._since_prefill >= self.decode_ratio)
        if may_admit and self.plan(n_queued, n_active) > n_active:
            self._since_prefill = 0
            return "prefill"
        self._since_prefill += 1
        return "decode"

    def observe(self, record: TickRecord) -> None:
        self.inner.observe(record)


class DisaggScheduler(Scheduler):
    """Phase policy for a disaggregated front-end
    (:class:`repro_torch.serving.DisaggregatedEngine`).

    Priorities: drain the **handoff** queue first (a stranded handoff is
    finished prefill work resident on *neither* engine — it holds cache
    state hostage while both sides idle).  Otherwise, prefill and decode
    live on *separate engines*, so when both sides have work the answer
    is ``"mixed"`` — both advance every front-end tick, which is what
    makes the disaggregation guarantee real: a sustained arrival stream
    keeps the prefill engine busy forever without ever costing the
    resident decodes a tick (a strict prefill-first policy would starve
    them).  Only when one side is idle does the tick dedicate to the
    other.

    ``handoff_depth`` is poked by the front-end before each ``phase()``
    call — the two-int ``phase(n_queued, n_active)`` signature is shared
    with every other scheduler, and ``n_queued`` there is the *total*
    front-end backlog (prefill queue + handoff queue).  On a plain
    :class:`repro_torch.serving.EngineCore` nothing sets ``handoff_depth``, a
    ``"handoff"`` answer is coerced to ``"mixed"``, and the scheduler
    degrades to interleaving-style prefill/decode separation.

    ``overlap=True`` answers ``"mixed"`` instead of ``"handoff"`` when
    the handoff queue is non-empty: transfer, prefill and decode all
    advance in the same front-end tick.  This is the phase policy built
    for an *async* :class:`repro_torch.serving.Transport`
    (``device_to_device``): delivery is dispatch-only, so draining the
    queue inside a mixed tick costs the decodes nothing — a dedicated
    handoff phase would just add dead ticks.  With a blocking transport
    the default drain-first policy keeps the (expensive) transfer out
    of the way of a whole-pool mixed tick.
    """

    def __init__(self, overlap: bool = False):
        self.handoff_depth = 0
        self.overlap = overlap

    def phase(self, n_queued: int, n_active: int) -> str:
        if self.handoff_depth > 0:
            return "mixed" if self.overlap else "handoff"
        if n_queued > 0 and n_active > 0:
            return "mixed"            # separate engines: advance both
        if n_queued > 0:
            return "prefill"
        if n_active > 0:
            return "decode"
        return "mixed"


class PriorityScheduler(Scheduler):
    """Priority classes with lossless preemption.

    Requests carry an integer ``priority`` (0 = most urgent — the engine
    stamps it onto every :class:`~repro_torch.serving.core.SlotTask` at
    submit).  Two policies compose here:

      * **admission order** — ``select()`` picks the queued task with the
        smallest ``(priority, arrival)`` key, so higher classes jump the
        queue but admission stays FIFO *within* a class (starvation-free
        per class; a sustained stream of higher-priority work may starve
        a lower class by design — that is what the priority contract
        means, and what SLO admission control upstream is for).
      * **preemption** — when a queued task outranks a resident and no
        slot is free, ``preempt()`` evicts the *lowest*-priority resident
        (at most ``max_evictions_per_tick`` per tick).  Eviction is
        lossless: the engine's ``_evict`` hook saves the resident's
        resumable state (LM: cache rows + generated tokens, via the same
        ``gather_cache_rows`` machinery cache handoffs use) and the task
        requeues, resuming later exactly where it stopped.

    Ties never preempt: a resident is only evicted for a *strictly*
    more urgent queued task, so equal-priority traffic cannot ping-pong.
    Admission size / shape / placement / phase delegate to ``inner``
    (FIFO unless given), so SLO batching or interleaving compose below.
    """

    def __init__(self, inner: Optional[Scheduler] = None,
                 max_evictions_per_tick: int = 1):
        if max_evictions_per_tick < 0:
            raise ValueError("max_evictions_per_tick must be >= 0")
        self.inner = inner or FIFOScheduler()
        self.max_evictions_per_tick = int(max_evictions_per_tick)

    def bind(self, core: Any) -> None:
        super().bind(core)
        self.inner.bind(core)

    def plan(self, n_queued: int, n_active: int) -> int:
        return self.inner.plan(n_queued, n_active)

    def phase(self, n_queued: int, n_active: int) -> str:
        return self.inner.phase(n_queued, n_active)

    def quantize(self, n_active: int, capacity: int) -> int:
        return self.inner.quantize(n_active, capacity)

    def shapes(self, capacity: int) -> tuple:
        return self.inner.shapes(capacity)

    def place(self, batch: Any) -> Any:
        return self.inner.place(batch)

    def observe(self, record: TickRecord) -> None:
        self.inner.observe(record)

    @staticmethod
    def _prio(task: Any) -> int:
        return int(getattr(task, "priority", 0))

    def select(self, queue: Any) -> int:
        best, best_p = 0, None
        for i, task in enumerate(queue):
            p = self._prio(task)
            if best_p is None or p < best_p:   # strict: FIFO within class
                best, best_p = i, p
        return best

    def preempt(self, queued: Any, residents: Any) -> tuple:
        if not queued or not residents or not self.max_evictions_per_tick:
            return ()
        free = self.capacity - len(residents)
        # most-urgent queued first; worst resident is the only candidate
        want = sorted(self._prio(t) for t in queued)
        victims = sorted(residents, key=lambda st: self._prio(st[1]),
                         reverse=True)
        out = []
        for p in want:
            if free > 0:               # a free slot serves this admission
                free -= 1
                continue
            if len(out) >= self.max_evictions_per_tick or not victims:
                break
            if self._prio(victims[0][1]) > p:    # strictly less urgent
                out.append(victims.pop(0)[0])
            else:
                break
        return tuple(out)


class ShardedScheduler(Scheduler):
    """Split each tick's batch across mesh devices (pure data-parallel
    serving), the twin of the reference's.

    ``n_devices`` is the product of the mesh axes the ``batch`` logical
    axis maps to under ``rules`` (``("pod", "data")`` by default), and
    ``devices`` the device of each block (``parallel.sharding.
    batch_devices``; a degenerate mesh may name one device twice).
    ``place()`` returns the tick array split into contiguous blocks along
    its leading (batch) axis, each on its device.  Admission, latency
    adaptation and tick phasing delegate to ``inner`` (FIFO unless given,
    so an SLO or interleaving controller composes under sharding).

    Workloads:

      * **image** (:class:`repro_torch.serving.CapsuleEngine`) — stateless
        ticks: the frame batch is split by ``place()`` and each block runs
        through its device's replica of the model.
      * **LM decode** (:class:`repro_torch.serving.ServeEngine`) —
        stateful: the engine keeps each block of ``capacity / n_devices``
        slots (caches or pages) on its device for the whole decode and
        routes the per-tick token and position arrays through
        ``place()``.  Engine capacity must divide evenly over the
        batch-axis devices (checked in ``bind``).

    One host thread drives every device, as the reference's single
    controller does; there is no process group and no collective.
    """

    def __init__(self, mesh: Any, inner: Optional[Scheduler] = None,
                 rules: Any = None):
        from repro_torch.parallel import sharding as sharding_lib

        self.mesh = mesh
        self.inner = inner or FIFOScheduler()
        self.rules = (rules if rules is not None
                      else sharding_lib.DEFAULT_RULES)
        axes = self.rules.lookup("batch", mesh.axis_names)
        axes = (axes,) if isinstance(axes, str) else (axes or ())
        self.n_devices = 1
        for a in axes:
            self.n_devices *= int(mesh.shape[a])
        self.devices = sharding_lib.batch_devices(mesh, self.rules)

    def bind(self, core: Any) -> None:
        super().bind(core)
        if self.capacity % self.n_devices:
            raise ValueError(
                f"engine capacity {self.capacity} not divisible by the "
                f"{self.n_devices} batch-axis devices of the mesh")
        self.inner.bind(core)

    def plan(self, n_queued: int, n_active: int) -> int:
        return self.inner.plan(n_queued, n_active)

    def phase(self, n_queued: int, n_active: int) -> str:
        return self.inner.phase(n_queued, n_active)

    def quantize(self, n_active: int, capacity: int) -> int:
        b = self.inner.quantize(n_active, capacity)
        b = -(-b // self.n_devices) * self.n_devices     # ceil to multiple
        return min(b, capacity)

    def shapes(self, capacity: int) -> tuple:
        return tuple(sorted({self.quantize(b, capacity)
                             for b in self.inner.shapes(capacity)}))

    def place(self, batch: Any) -> list:
        """The batch (numpy or a tensor, batch axis leading) as a list of
        contiguous blocks, block ``k`` on ``devices[k]``: as many blocks
        as the shape-aware policy splits the batch axis into (one, on the
        first device, when the batch does not divide)."""
        from repro_torch.parallel import sharding as sharding_lib

        x = (batch if isinstance(batch, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(batch)))
        spec = sharding_lib.shape_aware_spec(
            ("batch",) + (None,) * (x.dim() - 1), tuple(x.shape), self.rules,
            self.mesh.shape)
        axes = spec[0] if len(spec) else None
        devices = (sharding_lib.batch_devices(
            self.mesh, sharding_lib.AxisRules({"batch": axes}))
            if axes is not None else self.devices[:1])
        blocks = torch.split(x, x.shape[0] // len(devices))
        return [_to(b, dev) for b, dev in zip(blocks, devices)]

    def observe(self, record: TickRecord) -> None:
        self.inner.observe(record)


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: a host block is pinned and copied without
    waiting (the copy is ordered before the block's work on its
    stream)."""
    if x.device.type == "cpu" and device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)

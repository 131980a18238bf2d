"""Pluggable :class:`CacheHandoff` delivery between serving engines.

A disaggregated front-end hands a request's decode state (its cache rows)
from the prefill engine to a decode engine.  This module makes that
transfer a typed, measured, swappable stage:

  * :class:`Transport` — the contract.  ``deliver(handoff, target)``
    moves ``handoff.rows`` onto the target engine's device and returns a
    :class:`TransferRecord` with per-leg wall-clock timings.  Delivery is
    all-or-nothing: ``handoff.rows`` is reassigned only on success, so a
    failed delivery never leaves a half-moved tree and the front-end can
    requeue the handoff onto a surviving route.  ``close()`` is
    idempotent; delivering through a closed transport raises
    :class:`TransportError`.
  * :class:`InProcessTransport` — rows pass through untouched (one
    ``pass`` leg, ~0 cost).  The right choice when prefill and decode share
    a device.
  * :class:`HostStagedTransport` — explicit device -> host -> device
    staging with per-leg timing (``d2h``, ``h2d``), both legs synchronised
    before they are timed.  The portable route, and the yardstick the
    overlapped transport is measured against: its cost sits fully on the
    decode critical path.
  * :class:`DeviceToDeviceTransport` — a copy onto the target's device
    issued on a side CUDA stream and not waited for (one ``dispatch``
    leg): it overlaps with the decode ticks issued after it.  A CUDA event
    travels with the rows (``handoff.ready``), and the decode engine makes
    its stream wait on it before its scatter reads them.

The port has no device meshes yet, so a target's placement is its
``device`` attribute (:func:`target_device`).  Per-leg timings land in
``EngineStats.transfer`` as ``"<transport>/<leg>"`` histograms plus a
``"<transport>/total"`` critical-path histogram when a
:class:`repro_torch.serving.DisaggregatedEngine` drives the transport.
Every transport also keeps its own bounded ring of
:class:`TransferRecord`\\ s and an optional ``on_transfer`` hook.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.lm import cache_row_nbytes

__all__ = [
    "TransferRecord", "Transport", "TransportError",
    "InProcessTransport", "HostStagedTransport", "DeviceToDeviceTransport",
    "TRANSPORTS", "make_transport", "select_transport", "target_device",
]


class TransportError(RuntimeError):
    """A transport could not deliver a handoff (closed, or the move
    itself failed).  The front-end treats it like an engine death: the
    handoff requeues onto a surviving route, never dropped."""


@dataclasses.dataclass(frozen=True)
class TransferRecord:
    """One delivered handoff, as the transport saw it.

    ``legs`` maps leg name -> seconds of *critical-path* wall-clock (the
    time ``deliver`` spent before returning — an asynchronous dispatch leg
    records only the enqueue cost).  ``nbytes`` is the payload size (0 for
    row-less done or stateless handoffs)."""

    transport: str
    rid: int
    legs: Dict[str, float]
    nbytes: int = 0

    @property
    def total_s(self) -> float:
        """Critical-path seconds this delivery cost the front-end."""
        return float(sum(self.legs.values()))


def target_device(target: Any) -> Optional[torch.device]:
    """The device a delivery target decodes on (its ``device``
    attribute, a CUDA device with its index), or ``None`` for a target
    that names none: rows then stay on the device each leaf is on."""
    dev = getattr(target, "device", None)
    if dev is None:
        return None
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def wait_ready(handoff: Any) -> None:
    """Make the current stream of the rows' device wait for a pending
    device-to-device copy of ``handoff.rows`` (no-op when none is
    pending)."""
    ready = getattr(handoff, "ready", None)
    if ready is None or getattr(handoff, "rows", None) is None:
        return
    leaves = tree_leaves(handoff.rows)
    if leaves and leaves[0].is_cuda:
        torch.cuda.current_stream(leaves[0].device).wait_event(ready)


def _sync_streams(devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


class Transport:
    """Base contract for moving :class:`repro_torch.serving.CacheHandoff`
    rows between a prefill engine and a decode engine.

    Subclasses implement :meth:`_move`; everything else — close
    semantics, record keeping, the all-or-nothing rows swap — is shared
    so every implementation satisfies the same conformance suite.
    ``clock`` is injectable for deterministic tests."""

    name = "base"
    #: leg names this transport records for a rows-carrying delivery, in
    #: order — the conformance suite pins them as part of the contract
    LEGS: tuple = ()

    def __init__(self,
                 on_transfer: Optional[Callable[[TransferRecord],
                                                None]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 keep_records: int = 256):
        self._on_transfer = on_transfer
        self._clock = clock
        self._lock = threading.Lock()
        self._closed = False                        # guarded-by: _lock
        self._records: Deque[TransferRecord] = (    # guarded-by: _lock
            deque(maxlen=keep_records))

    # -- contract ----------------------------------------------------------

    def deliver(self, handoff: Any, target: Any) -> TransferRecord:
        """Move ``handoff.rows`` onto ``target``'s device.

        Returns the :class:`TransferRecord`.  ``handoff.rows`` (and
        ``handoff.ready``, the event of an asynchronous copy) is
        reassigned only when the whole move succeeded; on any failure the
        handoff is exactly as it was, so the caller can retry it on
        another route.  Raises :class:`TransportError` when closed."""
        with self._lock:
            if self._closed:
                raise TransportError(
                    f"{self.name} transport is closed; cannot deliver "
                    f"handoff rid={getattr(handoff, 'rid', '?')}")
        rows = getattr(handoff, "rows", None)
        if rows is None:              # done/stateless handoff: nothing moves
            legs: Dict[str, float] = {}
            nbytes = 0
        else:
            nbytes = cache_row_nbytes(rows)
            # rows an earlier asynchronous delivery is still writing are
            # waited for before they are read again
            wait_ready(handoff)
            moved, legs, ready = self._move(rows, target)
            handoff.rows = moved      # all-or-nothing: only on success
            handoff.ready = ready
        rec = TransferRecord(transport=self.name,
                             rid=int(getattr(handoff, "rid", -1)),
                             legs=legs, nbytes=nbytes)
        with self._lock:
            self._records.append(rec)
        if self._on_transfer is not None:
            self._on_transfer(rec)
        return rec

    def _move(self, rows: Any, target: Any):
        """Move one rows tree; returns ``(moved_rows, legs, ready)``, where
        ``ready`` is the CUDA event the consumer must wait on before
        reading ``moved_rows`` (``None`` when the move has finished).
        Subclass hook — must not mutate ``rows`` in place."""
        raise NotImplementedError

    def close(self) -> None:
        """Idempotent: after the first call every ``deliver`` raises
        :class:`TransportError`; closing again is a no-op."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def records(self):
        """Snapshot of the most recent :class:`TransferRecord`\\ s, in
        delivery order (bounded ring, ``keep_records`` deep)."""
        with self._lock:
            return list(self._records)


class InProcessTransport(Transport):
    """Rows stay exactly where the prefill engine left them.  Correct
    whenever both engines address the same device."""

    name = "in_process"
    LEGS = ("pass",)

    def _move(self, rows: Any, target: Any):
        t0 = self._clock()
        return rows, {"pass": max(self._clock() - t0, 0.0)}, None


class HostStagedTransport(Transport):
    """Explicit device -> host -> device staging, both legs synchronised.

    ``d2h`` copies every leaf into host memory (pinned for a CUDA leaf)
    and waits for the copies; ``h2d`` copies the host tree onto the
    target's device and waits for that stream too, so both legs time the
    copy and not its enqueue.  The whole round trip sits on the decode
    critical path."""

    name = "host_staged"
    LEGS = ("d2h", "h2d")

    def _move(self, rows: Any, target: Any):
        dev = target_device(target)
        leaves = tree_leaves(rows)
        t0 = self._clock()

        def to_host(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            return h.copy_(x, non_blocking=x.is_cuda)

        host = tree_map(to_host, rows)
        _sync_streams({x.device for x in leaves})
        t1 = self._clock()
        staged = tree_map(
            lambda h, x: h.to(dev if dev is not None else x.device,
                              non_blocking=True), host, rows)
        _sync_streams({x.device for x in tree_leaves(staged)})
        t2 = self._clock()
        return staged, {"d2h": max(t1 - t0, 0.0),
                        "h2d": max(t2 - t1, 0.0)}, None


class DeviceToDeviceTransport(Transport):
    """A copy onto the target's device, overlapped with decode ticks.

    On a CUDA target each leaf's destination is allocated on the target's
    current stream (the stream the decode engine reads it on), and the
    copies run on a side stream that first waits for the work already
    queued there (the gather that wrote the source rows).  The source is
    kept alive for the side stream (``record_stream``), so the caching
    allocator does not reuse the prefill engine's rows while the copy
    runs.  The event recorded after the copies travels with the rows; the
    decode engine's stream waits on it before its scatter.  The
    ``dispatch`` leg times the enqueue alone.  On a CPU target (a caller
    that asked for the CPU) the copy is a plain ``clone``."""

    name = "device_to_device"
    LEGS = ("dispatch",)

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self._streams: Dict[torch.device, Any] = {}   # guarded-by: _lock

    def _side_stream(self, dev: torch.device):
        with self._lock:
            side = self._streams.get(dev)
            if side is None:
                side = self._streams[dev] = torch.cuda.Stream(dev)
            return side

    def _move(self, rows: Any, target: Any):
        dev = target_device(target)
        t0 = self._clock()
        leaves = tree_leaves(rows)
        if dev is None:
            dev = leaves[0].device if leaves else torch.device("cpu")
        if dev.type != "cuda":
            moved = tree_map(lambda x: x.to(dev).clone(), rows)
            return moved, {"dispatch": max(self._clock() - t0, 0.0)}, None
        side = self._side_stream(dev)
        consumer = torch.cuda.current_stream(dev)
        moved = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device=dev), rows)
        side.wait_stream(consumer)
        for src_dev in {x.device for x in leaves if x.is_cuda}:
            if src_dev != dev:
                side.wait_stream(torch.cuda.current_stream(src_dev))
        with torch.cuda.stream(side):
            for dst, src in zip(tree_leaves(moved), leaves):
                dst.copy_(src, non_blocking=True)
                if src.is_cuda:
                    src.record_stream(side)
            ready = torch.cuda.Event()
            ready.record(side)
        # deliberately no synchronisation: the whole point is overlap
        return moved, {"dispatch": max(self._clock() - t0, 0.0)}, ready


TRANSPORTS: Dict[str, type] = {
    InProcessTransport.name: InProcessTransport,
    HostStagedTransport.name: HostStagedTransport,
    DeviceToDeviceTransport.name: DeviceToDeviceTransport,
}


def make_transport(kind: str, **kwargs: Any) -> Transport:
    """Build a transport by name (``in_process`` / ``host_staged`` /
    ``device_to_device``); kwargs forward to the constructor."""
    try:
        cls = TRANSPORTS[kind]
    except KeyError:
        raise ValueError(
            f"unknown transport {kind!r}; choose from "
            f"{sorted(TRANSPORTS)}") from None
    return cls(**kwargs)


def select_transport(prefill: Any, decodes: Any, **kwargs: Any) -> Transport:
    """Auto-selection: device-to-device when any decode engine's device
    differs from the prefill engine's (rows must actually move), else
    in-process.  On a one-card host every engine shares the card, so this
    picks in-process; so does a stateless pool (``prefill=None``), whose
    handoffs carry no rows."""
    if prefill is None:
        return InProcessTransport(**kwargs)
    pre = target_device(prefill)
    for eng in decodes or ():
        dev = target_device(eng)
        if dev is not None and dev != pre:
            return DeviceToDeviceTransport(**kwargs)
    return InProcessTransport(**kwargs)

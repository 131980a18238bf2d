"""EngineCore: the one serving loop every workload adapter shares.

The paper's Fig. 1 numbers are *served* throughput, so serving is a
first-class API, not a demo loop.  ``EngineCore`` owns everything that is
workload-independent about a slot-based, fixed-shape inference engine:

  * **slot state** — ``capacity`` slots, each holding one
    :class:`SlotTask`; a request expands into one or more tasks (CapsNet:
    one per frame; LM: one per sequence) that occupy a slot from admission
    until completion;
  * **async admission** — ``submit()`` only touches the queue under a
    lock, so requests can arrive from other threads (or from callbacks
    fired mid-tick) while a tick is in flight; the next tick picks them
    up;
  * **the tick** — admit up to ``scheduler.plan()`` tasks, let the
    workload prefill/step a schedulable, fixed-shape batch, then retire
    finished slots and emit completions; ``scheduler.phase()`` may
    dedicate a tick to admission (prefill) or stepping (decode) instead
    of the default mixed tick;
  * **streaming** — workloads may emit per-item :class:`StreamEvent`\\ s
    (LM: one per generated token) for requests that opted in;
    ``poll(stream=True)`` drains them while plain ``poll()`` keeps the
    completion-level contract;
  * **cumulative stats** — monotone counters (items, padding waste,
    ticks, wall-clock, completed requests) plus per-request-class
    latency histograms (p50/p95), shared by every workload.

Workload adapters (:class:`repro_torch.serving.CapsuleEngine`; the LM
decode engine follows with the LM slice of the port) subclass this and
implement four hooks — ``_expand`` / ``_admit`` / ``_step`` /
``_finalize`` — giving every workload the same
``submit() / poll() / run_until_idle() / stats()`` surface.

Scheduling (effective batch size, compiled shape, device placement) is
delegated to a pluggable :class:`repro_torch.serving.Scheduler`.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.kernels import tuning as kernel_tuning
from repro_torch.serving.schedulers import FIFOScheduler, Scheduler, TickRecord


class _Log2Histogram:
    """Shared fixed-bucket histogram core (counts only, O(1) memory).

    Subclasses define ``BOUNDS`` — ascending bucket upper bounds, plus an
    implicit overflow bucket — so ``record`` never rebins and two
    snapshots of the same histogram are comparable bucket by bucket.
    ``_percentile`` reports the upper bound of the bucket the requested
    quantile falls in (Prometheus-style: pessimistic by at most one
    bucket width).  There is exactly one quantile implementation; the
    latency and depth views only differ in bounds, units and extras.
    """

    BOUNDS: tuple = ()

    def __init__(self):
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.count = 0

    def _record(self, value) -> None:
        self.counts[bisect.bisect_left(self.BOUNDS, value)] += 1
        self.count += 1

    def _percentile(self, q: float) -> float:
        """Bucket upper bound below which ``q`` percent of observations
        fell; 0.0 for an empty histogram."""
        if not self.count:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return (float(self.BOUNDS[i]) if i < len(self.BOUNDS)
                        else float("inf"))
        return float("inf")

    def copy(self):
        out = type(self)()
        for k, v in self.__dict__.items():
            setattr(out, k, list(v) if isinstance(v, list) else v)
        return out


class LatencyHistogram(_Log2Histogram):
    """Latency histogram: buckets span 50 us to ~45 min (pow2 upper
    bounds in ms).  ``record`` takes seconds; percentiles report ms."""

    BOUNDS_MS = tuple(0.05 * 2 ** i for i in range(26))   # 0.05ms..~45min
    BOUNDS = BOUNDS_MS

    def __init__(self):
        super().__init__()
        self.total_s = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        self._record(s * 1e3)
        self.total_s += s

    def percentile_ms(self, q: float) -> float:
        """Latency (ms) below which ``q`` percent of requests completed;
        0.0 for an empty histogram."""
        return self._percentile(q)

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p95_ms(self) -> float:
        return self.percentile_ms(95.0)

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.count if self.count else 0.0

    def __repr__(self) -> str:
        return (f"LatencyHistogram(n={self.count}, p50={self.p50_ms:.3g}ms, "
                f"p95={self.p95_ms:.3g}ms)")


class DepthHistogram(_Log2Histogram):
    """Histogram of non-negative integer levels (queue depths observed
    at each tick): buckets 0, 1, 2, 4, ... 2**19 plus overflow, and
    ``peak`` keeps the exact high-water mark."""

    BOUNDS = (0,) + tuple(2 ** i for i in range(20))

    def __init__(self):
        super().__init__()
        self.total = 0
        self.peak = 0

    def record(self, depth: int) -> None:
        d = max(int(depth), 0)
        self._record(d)
        self.total += d
        self.peak = max(self.peak, d)

    def percentile(self, q: float) -> float:
        """Depth below which ``q`` percent of observations fell; 0.0 for
        an empty histogram."""
        return self._percentile(q)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __repr__(self) -> str:
        return (f"DepthHistogram(n={self.count}, p50={self.p50:.3g}, "
                f"p95={self.p95:.3g}, peak={self.peak})")


@dataclasses.dataclass
class EngineStats:
    """Cumulative over the engine's lifetime (monotone non-decreasing).

    ``items`` are workload units: frames for the image workload, generated
    tokens for LM decode.  The ``frames``/``batches`` aliases keep the
    image-serving vocabulary of the original CapsuleEngine stats.

    ``latency`` maps a *request class* (the workload's coarse label for a
    request, e.g. ``"lm/p8"`` for prompts bucketed to length 8 — see
    ``EngineCore._request_class``) to a :class:`LatencyHistogram` of
    submit-to-completion wall-clock, so p50/p95 can be read per class
    without retaining per-request records.  Snapshots from ``stats()``
    deep-copy the histograms: they never mutate under the caller.

    ``depth`` maps a tick *phase* (``"mixed"`` / ``"prefill"`` /
    ``"decode"``, plus ``"handoff"`` on a disaggregated front-end) to a
    :class:`DepthHistogram` of the queue depth observed at each tick of
    that phase, and ``transfer`` maps a handoff stage to a
    :class:`LatencyHistogram` of its transfer wall-clock — both only
    populated by engines that run the corresponding phase.  The
    ``transfer`` key vocabulary on a disaggregated front-end:
    ``"handoff"`` is the queue wait (prefill completion to decode
    submit), and each routed :class:`repro_torch.serving.Transport` adds
    per-leg critical-path histograms ``"<transport>/<leg>"`` (e.g.
    ``"host_staged/d2h"``, ``"device_to_device/dispatch"``) plus a
    ``"<transport>/total"`` sum — the yardstick for how much delivery
    cost sits on the decode critical path.
    """

    items: int = 0                    # real work units served
    padded: int = 0                   # zero-pad slot waste
    ticks: int = 0                    # engine ticks that did work
    wall_s: float = 0.0               # time spent in admit+step
    completed: int = 0                # requests fully served
    preempted: int = 0                # resident tasks evicted + requeued
    latency: Dict[str, LatencyHistogram] = dataclasses.field(
        default_factory=dict)         # request class -> latency histogram
    depth: Dict[str, DepthHistogram] = dataclasses.field(
        default_factory=dict)         # tick phase -> queue-depth histogram
    transfer: Dict[str, LatencyHistogram] = dataclasses.field(
        default_factory=dict)         # handoff stage / transport leg ->
    #                                   transfer latency
    pages: Dict[str, int] = dataclasses.field(
        default_factory=dict)         # paged-KV counters (allocations,
    #                                   prefix hits, prefill savings —
    #                                   see repro_torch.serving.pages)

    @property
    def throughput(self) -> float:
        """Items (frames / tokens) per second of engine wall-clock."""
        return self.items / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def ms_per_tick(self) -> float:
        return 1e3 * self.wall_s / self.ticks if self.ticks else 0.0

    def latency_summary(self) -> Dict[str, Tuple[int, float, float]]:
        """``{request class: (count, p50 ms, p95 ms)}`` for reporting."""
        return {k: (h.count, h.p50_ms, h.p95_ms)
                for k, h in sorted(self.latency.items())}

    def depth_summary(self) -> Dict[str, Tuple[int, float, float, int]]:
        """``{phase: (ticks, p50 depth, p95 depth, peak)}`` for reporting."""
        return {k: (h.count, h.p50, h.p95, h.peak)
                for k, h in sorted(self.depth.items())}

    def transfer_summary(self) -> Dict[str, Tuple[int, float, float]]:
        """``{handoff stage: (count, p50 ms, p95 ms)}`` for reporting."""
        return {k: (h.count, h.p50_ms, h.p95_ms)
                for k, h in sorted(self.transfer.items())}

    # image-serving aliases (Fig. 1 vocabulary)
    fps = throughput
    frames = property(lambda self: self.items)
    padded_frames = property(lambda self: self.padded)
    batches = property(lambda self: self.ticks)
    ms_per_batch = ms_per_tick


@dataclasses.dataclass
class SlotTask:
    """One schedulable unit of a request (a frame, or a whole sequence)."""

    payload: Any                      # workload-specific immutable input
    rid: int = -1                     # owning request id (set at submit)
    priority: int = 0                 # request priority (0 = most urgent)
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StreamEvent:
    """One token-level (or frame-level) result on the streaming channel.

    ``seq`` is the 0-based per-request emission index — strictly
    increasing per rid, so consumers can assert ordering.  The final
    event of a request has ``done=True``, ``item=None`` and carries the
    request's completion object (the same object plain ``poll()``
    returns), making the stream self-contained.  One caveat: completed
    rids may be reused by a later ``submit()``, and a reused rid's
    events restart at ``seq=0`` — drain ``poll(stream=True)`` before
    reusing an explicit rid, or let the engine assign fresh rids.
    """

    rid: int
    seq: int
    item: Any = None                  # token id / frame class, None on done
    done: bool = False
    completion: Any = None            # set on the done event only


def allocate_rid(request: Any, inflight: Dict[int, Any], next_rid: int
                 ) -> Tuple[int, int]:
    """Resolve a request's rid under THE engine rid rules (one place —
    :class:`EngineCore` and the disaggregated front-end must not drift):
    ``None`` takes the next auto id; an explicit id bumps the auto
    counter past itself so later auto ids never collide; an id already
    in ``inflight`` raises.  Sets ``request.rid``; returns
    ``(rid, next_rid)``.  Caller must hold its state lock."""
    rid = getattr(request, "rid", None)
    if rid is None:
        rid = next_rid
        next_rid += 1
    elif rid >= next_rid:
        next_rid = rid + 1
    if rid in inflight:
        raise ValueError(f"duplicate rid {rid}")
    request.rid = rid
    return rid, next_rid


@dataclasses.dataclass
class _RequestEntry:
    request: Any
    tasks: List[SlotTask]
    state: Dict[str, Any]
    left: int
    t0: float
    cls: str = "default"              # request class (latency histogram key)
    stream: bool = False              # emit StreamEvents for this request
    emitted: int = 0                  # next StreamEvent.seq


class EngineCore:
    """Slot engine skeleton; subclass and implement the workload hooks.

    Hooks (called with the tick lock *released*, single ticker at a time):

      * ``_expand(request) -> (tasks, request_state)`` — validate and
        split a request into :class:`SlotTask`s (may raise ``ValueError``);
      * ``_admit(new) -> (finished_slot_ids, items)`` — react to tasks
        newly placed in slots (LM: ragged batched prefill);
      * ``_step(active, n_batch) -> (finished_slot_ids, items)`` — run one
        fixed-shape tick over the occupied slots;
      * ``_finalize(entry, latency_s) -> completion`` — build the
        completion object once all of a request's tasks finished;
      * ``_batch_for(n_active) -> int`` — compiled batch for this tick
        (defaults to ``scheduler.quantize``; fixed-cache workloads
        override to capacity);
      * ``_warmup()`` — optional first run of every tick shape outside
        the measured path (on the card this also builds and loads the
        kernels);
      * ``_pretune()`` — optional measured kernel autotuning with
        concrete example inputs, run by ``warmup()`` before ``_warmup``
        when ``kernel_tune=True``.

    ``kernel_tune`` selects the engine's kernel-config policy: ``True``
    runs every hook against the autotuner cache (the
    :mod:`repro_torch.kernels` registry resolves the tuned launch
    geometry at each call), ``False`` pins the deterministic defaults,
    and ``None`` (default) inherits the ambient
    :func:`repro_torch.kernels.tuning.tuning` policy.

    ``clock`` is injectable so schedulers can be tested against a
    deterministic time source.
    """

    def __init__(self, capacity: int, scheduler: Optional[Scheduler] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 kernel_tune: Optional[bool] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.kernel_tune = kernel_tune
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.bind(self)
        self._clock = clock
        self._slots: List[Optional[SlotTask]] = (      # guarded-by: _lock
            [None] * self.capacity)
        self._queue: Deque[SlotTask] = deque()         # guarded-by: _lock
        self._requests: Dict[int, _RequestEntry] = {}  # guarded-by: _lock
        self._completions: Deque[Any] = deque()        # guarded-by: _lock
        self._events: Deque[StreamEvent] = deque()     # guarded-by: _lock
        self._stats = EngineStats()                    # guarded-by: _lock
        self._tick_excluded = 0.0      # one-off hook time (autotuning);
        #                                ticker-private (under _tick_lock)
        self._next_rid = 0                             # guarded-by: _lock
        self._lock = threading.Lock()          # queue / requests / stats
        self._tick_lock = threading.Lock()     # one ticker at a time

    # -- workload hooks ----------------------------------------------------

    def _expand(self, request: Any) -> Tuple[List[SlotTask], Dict[str, Any]]:
        raise NotImplementedError

    def _admit(self, new: List[Tuple[int, SlotTask]]
               ) -> Tuple[List[int], int]:
        return [], 0

    def _step(self, active: List[Tuple[int, SlotTask]], n_batch: int
              ) -> Tuple[List[int], int]:
        raise NotImplementedError

    def _finalize(self, entry: _RequestEntry, latency_s: float) -> Any:
        raise NotImplementedError

    def _batch_for(self, n_active: int) -> int:
        return self.scheduler.quantize(n_active, self.capacity)

    def _warmup(self) -> None:
        pass

    def _evict(self, slot: int, task: SlotTask) -> None:
        """Save ``task``'s resumable state before it is requeued (called
        with the slot already freed, tick lock held, state lock
        released).  Preemption must be *lossless*: ``_admit`` of a
        requeued task must continue exactly where it stopped, so
        workloads with carried state override this to capture it (LM:
        cache rows / pending token / position — see
        ``ServeEngine._evict``).  The default saves nothing, which is
        correct only for workloads whose ``_admit`` is already
        resume-aware (e.g. a countdown kept in ``task.state``)."""

    def _release_slot(self, slot: int, task: SlotTask) -> None:
        """Reclaim per-slot workload resources after ``task`` finished
        and its slot was retired (called once per finished slot, state
        lock released).  The dense cache needs nothing — the slot's
        rows are simply overwritten by the next admission — but the
        paged cache must drop the task's page references
        (``ServeEngine._release_slot``)."""

    def _pretune(self) -> None:
        """Measured kernel autotuning with concrete inputs (workloads
        override); runs before the warm-up so registry dispatch finds
        the cache populated."""
        pass

    def _kernel_scope(self):
        """Tuning-policy scope every hook runs under (fresh per use —
        context managers are single-shot)."""
        if self.kernel_tune is None:
            return contextlib.nullcontext()
        return kernel_tuning.tuning(self.kernel_tune)

    def _exclude_tick_time(self, seconds: float) -> None:
        """Hooks call this (ticker thread only) to mark one-off work —
        e.g. a measured kernel autotune on a first-seen shape bucket —
        so it is subtracted from the tick wall before throughput stats
        and ``scheduler.observe`` see it; an SLO scheduler must react to
        serving time, not to a one-time measurement."""
        self._tick_excluded += max(float(seconds), 0.0)

    def _request_class(self, request: Any) -> str:
        """Coarse label keying the latency histogram (override per
        workload; a small, bounded set of labels keeps stats O(1))."""
        return "default"

    def _wants_stream(self, request: Any) -> bool:
        """Whether this request opted into token-level StreamEvents
        (default: its ``stream`` attribute; absent means completion-only,
        so the legacy request types stream nothing)."""
        return bool(getattr(request, "stream", False))

    # -- internal helpers --------------------------------------------------

    def _emit(self, rid: int, item: Any) -> None:
        """Queue one streaming item for ``rid`` (no-op unless the request
        opted in).  Workload hooks may call this with the lock released —
        it re-acquires it — but only from the single ticker thread, which
        is what keeps ``seq`` strictly increasing per request."""
        with self._lock:
            entry = self._requests.get(rid)
            if entry is None or not entry.stream:
                return
            self._events.append(StreamEvent(rid=rid, seq=entry.emitted,
                                            item=item))
            entry.emitted += 1

    def _complete_locked(self, entry: _RequestEntry, now: float) -> None:
        """Finalize one request: completion queue, latency histogram, and
        the terminal StreamEvent for streaming requests.  Call with
        ``self._lock`` held."""
        completion = self._finalize(entry, max(now - entry.t0, 0.0))
        self._completions.append(completion)
        st = self._stats
        st.completed += 1
        st.latency.setdefault(
            entry.cls, LatencyHistogram()).record(max(now - entry.t0, 0.0))
        if entry.stream:
            self._events.append(StreamEvent(
                rid=entry.request.rid, seq=entry.emitted, done=True,
                completion=completion))
            entry.emitted += 1

    # -- shared surface ----------------------------------------------------

    def submit(self, request: Any) -> int:
        """Enqueue one request (thread-safe, non-blocking); returns its rid.

        May be called from any thread, including callbacks fired while a
        tick is in flight; the request joins the next tick's admission.
        ``request.rid`` is assigned when ``None``; explicit rids must be
        unique among in-flight requests (completed rids may be reused).
        Zero-task requests complete immediately.  Raises ``ValueError``
        (from the workload's ``_expand``) on malformed payloads before
        any engine state changes.
        """
        tasks, state = self._expand(request)
        prio = int(getattr(request, "priority", 0))
        with self._lock:
            rid, self._next_rid = allocate_rid(request, self._requests,
                                               self._next_rid)
            for t in tasks:
                t.rid = rid
                t.priority = prio
            entry = _RequestEntry(request=request, tasks=tasks, state=state,
                                  left=len(tasks), t0=self._clock(),
                                  cls=self._request_class(request),
                                  stream=self._wants_stream(request))
            if not tasks:
                self._complete_locked(entry, self._clock())
            else:
                self._requests[rid] = entry
                self._queue.extend(tasks)
        return rid

    def poll(self, stream: bool = False) -> List[Any]:
        """Drain results ready so far (thread-safe, non-blocking).

        * ``poll()`` — the completion-level contract: one workload
          completion object per finished request, in finish order.
          Every request (streaming or not) lands here, so
          ``run_until_idle()``/``serve()`` callers are unaffected by
          streaming.
        * ``poll(stream=True)`` — the token-level channel: ordered
          :class:`StreamEvent`\\ s for requests that opted in
          (``request.stream=True``), one per emitted item, terminated
          per request by a ``done=True`` event carrying the completion.
          Events for different requests interleave in emission order;
          ``seq`` is strictly increasing within a rid.

        The two channels drain independently: a streaming consumer that
        never calls plain ``poll()`` should discard its completions
        eventually, and vice versa a completion-level consumer of a
        streaming request should drain ``poll(stream=True)`` or not set
        ``stream`` — both queues are unbounded.
        """
        out: List[Any] = []
        with self._lock:
            src = self._events if stream else self._completions
            while src:
                out.append(src.popleft())
        return out

    def tick(self) -> bool:
        """One engine step: admit, run, retire.  Returns False when idle.

        ``scheduler.phase()`` picks the tick kind: ``"mixed"`` admits and
        steps (prefill rides the admission tick — the legacy behaviour),
        ``"prefill"`` dedicates the tick to admission (resident slots
        idle one tick), ``"decode"`` dedicates it to stepping (the queue
        waits).  Impossible answers are coerced back to ``"mixed"`` —
        ``"decode"`` with nothing resident, ``"prefill"`` with nothing
        queued, and any phase this engine has no machinery for (e.g. the
        ``"handoff"`` phase of a disaggregated front-end) — so no
        scheduler can stall the engine.  Each tick records the queue
        depth it observed under its phase in ``EngineStats.depth``.

        Before admission, ``scheduler.preempt()`` may evict residents in
        favour of higher-priority queued work: the slot frees, the
        workload's ``_evict`` hook saves the task's resumable state, and
        the task requeues at the front of the queue — never dropped, and
        its request entry (latency clock, stream ``seq``) is untouched.
        Admission then pops the queue at ``scheduler.select()`` instead
        of strictly left (default 0 keeps FIFO).
        """
        with self._tick_lock:
            with self._lock:
                queued = list(self._queue)
                residents = [(s, t) for s, t in enumerate(self._slots)
                             if t is not None]
                evicted: List[Tuple[int, SlotTask]] = []
                if queued and residents:
                    for s in self.scheduler.preempt(queued, residents):
                        s = int(s)
                        if 0 <= s < self.capacity \
                                and self._slots[s] is not None:
                            evicted.append((s, self._slots[s]))
                            self._slots[s] = None
            if evicted:
                for s, task in evicted:
                    self._evict(s, task)   # hooks run with lock released
                with self._lock:
                    for _, task in reversed(evicted):
                        self._queue.appendleft(task)
                    self._stats.preempted += len(evicted)
            with self._lock:
                n_active = sum(s is not None for s in self._slots)
                n_queued = len(self._queue)
                phase = self.scheduler.phase(n_queued, n_active)
                if phase not in ("prefill", "decode"):
                    phase = "mixed"   # incl. "handoff": no such stage here
                elif phase == "decode" and n_active == 0:
                    phase = "mixed"
                elif phase == "prefill" and n_queued == 0:
                    phase = "mixed"
                if n_queued or n_active:
                    self._stats.depth.setdefault(
                        phase, DepthHistogram()).record(n_queued)
                new: List[Tuple[int, SlotTask]] = []
                if phase != "decode":
                    plan = self.scheduler.plan(n_queued, n_active)
                    plan = max(1, min(int(plan), self.capacity))
                    for s in range(self.capacity):
                        if n_active >= plan or not self._queue:
                            break
                        if self._slots[s] is None:
                            i = int(self.scheduler.select(self._queue))
                            if not 0 <= i < len(self._queue):
                                i = 0
                            task = self._queue[i]
                            del self._queue[i]
                            self._slots[s] = task
                            new.append((s, task))
                            n_active += 1
                active = [(s, t) for s, t in enumerate(self._slots)
                          if t is not None]
            if not active:
                return False

            t0 = self._clock()
            self._tick_excluded = 0.0
            finished: List[int] = []
            items = 0
            with self._kernel_scope():
                if new:
                    f, i = self._admit(new)
                    finished += f
                    items += i
                done = set(finished)
                still = [(s, t) for s, t in active if s not in done]
                n_batch = 0
                if still and not (phase == "prefill" and new):
                    n_batch = max(len(still),
                                  min(self._batch_for(len(still)),
                                      self.capacity))
                    f, i = self._step(still, n_batch)
                    finished += f
                    items += i
            wall = max(self._clock() - t0 - self._tick_excluded, 0.0)

            retired: List[Tuple[int, SlotTask]] = []
            with self._lock:
                st = self._stats
                st.ticks += 1
                st.items += items
                st.padded += max(n_batch - len(still), 0)
                st.wall_s += wall
                now = self._clock()
                for s in finished:
                    task = self._slots[s]
                    self._slots[s] = None
                    retired.append((s, task))
                    entry = self._requests[task.rid]
                    entry.left -= 1
                    if entry.left == 0:
                        del self._requests[task.rid]
                        self._complete_locked(entry, now)
            for s, task in retired:
                self._release_slot(s, task)   # hooks run lock-released
            self.scheduler.observe(
                TickRecord(n_active=len(still), n_batch=n_batch, wall_s=wall))
            return True

    def run_until_idle(self) -> List[Any]:
        """Tick until queue and slots drain; returns the completions
        ready at exit (completion-level — streaming events stay queued
        for ``poll(stream=True)``).  Submissions made while running —
        from other threads or mid-tick callbacks — are served as long as
        they land before the engine observes an empty queue; a submit
        racing that final check stays queued for the next run/tick."""
        while True:
            if self.tick():
                continue
            if self.n_pending == 0:
                return self.poll()

    def serve(self, requests: List[Any]) -> List[Any]:
        """Submit all requests and run them to completion."""
        for r in requests:
            self.submit(r)
        return self.run_until_idle()

    def warmup(self) -> None:
        """Run every tick shape once outside the measured path.

        With ``kernel_tune=True`` this is also the bind point for tuned
        kernel configs: ``_pretune`` measures candidates (populating the
        on-disk autotuner cache), then the warm-up runs and every later
        tick pick the cached winners up."""
        with self._kernel_scope():
            if self.kernel_tune:
                self._pretune()
            self._warmup()

    def stats(self) -> EngineStats:
        """Snapshot of the cumulative :class:`EngineStats` (thread-safe).

        The snapshot is detached — counters and latency histograms are
        copied, so it never mutates as the engine keeps serving."""
        with self._lock:
            return dataclasses.replace(
                self._stats,
                latency={k: h.copy()
                         for k, h in self._stats.latency.items()},
                depth={k: h.copy()
                       for k, h in self._stats.depth.items()},
                transfer={k: h.copy()
                          for k, h in self._stats.transfer.items()},
                pages=dict(self._stats.pages))

    @property
    def n_pending(self) -> int:
        """Queued tasks + occupied slots (0 means the engine is idle)."""
        with self._lock:
            return len(self._queue) + sum(
                s is not None for s in self._slots)

    @property
    def n_queued(self) -> int:
        """Tasks waiting for a slot (backlog only — excludes residents;
        the quantity ``EngineStats.depth`` histograms record)."""
        with self._lock:
            return len(self._queue)

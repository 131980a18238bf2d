"""Open-loop trace replay against any engine, on a virtual clock.

:func:`replay` drives an engine (anything with the standard
``submit() / poll() / tick() / stats()`` surface — :class:`ServeEngine`,
:class:`CapsuleEngine`, :class:`DisaggregatedEngine`, or a test toy)
through a :class:`repro_torch.traffic.Trace`: events whose arrival time has
passed are submitted, the engine ticks, and the clock advances — open
loop, so a slow engine builds real backlog instead of the trace
politely waiting (that backlog is exactly what admission control and
autoscaling react to).

Time is a :class:`VirtualClock` by default: the replay owns ``now`` and
advances it by ``tick_dt`` per engine tick, jumping over silent gaps
when the engine is idle.  Engines constructed with the *same* clock
object measure request latency in virtual time, which makes latency
histograms deterministic across runs — the property the determinism
tests pin.  Passing ``clock=None`` uses wall-clock (the launcher's
live mode).

The loop also hosts the two closed-loop actors: an
:class:`repro_torch.traffic.AutoscaleController` (stepped once per tick, may
grow or drain the pool) and an :class:`repro_torch.traffic.SLOAdmission`
gate (consulted per arrival, may reject).  Everything that happened is
returned as a :class:`ReplayReport` — counts, per-class latency,
scale events, and the exact submission schedule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.traffic.traces import (Trace, TraceEvent,
                                        build_image_request,
                                        build_lm_request)

__all__ = ["VirtualClock", "ReplayReport", "replay", "default_factory"]


class _WallClock:
    """Live-mode clock: real time advances itself (``advance`` is a
    no-op — engine ticks take however long they take) and idle gaps are
    slept through.  ``now`` is relative to construction so it lines up
    with trace arrival times."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float) -> float:
        return self.now()

    def advance_to(self, t: float) -> float:
        time.sleep(max(float(t) - self.now(), 0.0))
        return self.now()


class VirtualClock:
    """A manually-advanced clock with the ``time.perf_counter`` calling
    convention (zero-arg callable returning seconds).  Inject one
    object into both the replay loop and the engines under test and
    every latency/transfer measurement becomes deterministic virtual
    time.  Monotone: ``advance`` rejects negative steps."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clock cannot run backwards")
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        self._now = max(self._now, float(t))
        return self._now


@dataclasses.dataclass
class ReplayReport:
    """What one replay did, in plain data (JSON-friendly).

    ``submitted + rejected == len(trace)``; ``dropped`` is the
    never-dropped invariant check (``submitted - completed`` after the
    drain — must be 0 for a healthy engine).  ``per_class`` maps class
    name to ``(count, p50_ms, p95_ms)`` end-to-end latency;
    ``schedule`` records ``(t, cls, rid)`` per submission in order, the
    determinism witness.  ``scale_events`` / ``mean_live_engines`` come
    from the controller when one ran (else empty / None).
    """

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    dropped: int = 0
    horizon: float = 0.0
    drain_s: float = 0.0              # virtual time spent draining
    per_class: Dict[str, Tuple[int, float, float]] = dataclasses.field(
        default_factory=dict)
    schedule: List[Tuple[float, str, int]] = dataclasses.field(
        default_factory=list)
    scale_events: List[Any] = dataclasses.field(default_factory=list)
    mean_live_engines: Optional[float] = None
    stats: Any = None                 # final EngineStats snapshot


def default_factory(trace: Trace, vocab: int = 256,
                    image_shape: Tuple[int, int, int] = (28, 28, 1)
                    ) -> Callable[[TraceEvent], Any]:
    """Event -> request factory dispatching on each class's ``kind``."""
    def make(ev: TraceEvent) -> Any:
        cls = trace.classes[ev.cls]
        if cls.kind == "image":
            return build_image_request(ev, cls, shape=image_shape)
        return build_lm_request(ev, cls, vocab=vocab)
    return make


def replay(engine: Any, trace: Trace,
           factory: Optional[Callable[[TraceEvent], Any]] = None,
           clock: Optional[VirtualClock] = None,
           tick_dt: float = 1e-3,
           controller: Any = None, admission: Any = None,
           max_ticks: int = 2_000_000) -> ReplayReport:
    """Replay ``trace`` against ``engine`` and drain to idle.

    ``clock`` should be the same :class:`VirtualClock` the engine was
    constructed with; ``clock=None`` runs live on wall time (idle gaps
    are slept through, ticks take as long as they take).  ``tick_dt``
    is the virtual duration charged per engine tick; when the engine
    goes idle with arrivals still ahead the clock jumps straight to the
    next arrival, so sparse traces replay in O(events), not
    O(horizon/tick_dt).

    Per arrival: ``admission.admit(engine, event, cls, now)`` (when
    given) may veto — vetoed events count as ``rejected`` and are never
    submitted (backpressure is explicit, not a silent drop).  Per tick:
    ``controller.step(engine, now)`` (when given) may scale the pool.
    ``max_ticks`` bounds runaway loops (raises rather than hangs).
    """
    clk = clock if clock is not None else _WallClock()
    make = factory if factory is not None else default_factory(trace)
    events = sorted(trace.events, key=lambda e: e.t)
    rep = ReplayReport(horizon=trace.horizon)
    i, n = 0, len(events)
    ticks = 0
    while True:
        now = clk.now()
        while i < n and events[i].t <= now:
            ev = events[i]
            i += 1
            cls = trace.classes[ev.cls]
            if admission is not None and not admission.admit(
                    engine, ev, cls, now):
                rep.rejected += 1
                continue
            rid = engine.submit(make(ev))
            rep.submitted += 1
            rep.schedule.append((ev.t, ev.cls, rid))
        if controller is not None:
            controller.step(engine, now)
        busy = engine.tick()
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(f"replay exceeded {max_ticks} ticks "
                               f"({engine.n_pending} still pending)")
        if busy or engine.n_pending:
            clk.advance(tick_dt)
        elif i < n:
            clk.advance_to(events[i].t)   # idle: jump the silent gap
        else:
            break                         # drained and no arrivals left
    rep.drain_s = max(clk.now() - trace.horizon, 0.0)
    # let a draining controller reap emptied engines before reporting
    if controller is not None:
        controller.step(engine, clk.now())
        rep.scale_events = list(getattr(controller, "events", []))
        rep.mean_live_engines = getattr(controller, "mean_live", None)
        if callable(rep.mean_live_engines):
            rep.mean_live_engines = rep.mean_live_engines()
    engine.poll()                     # drain the completion queue
    st = engine.stats()
    rep.completed = st.completed
    rep.dropped = rep.submitted - rep.completed
    rep.per_class = st.latency_summary()
    rep.stats = st
    return rep

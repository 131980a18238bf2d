"""Autoscaling controller for the elastic decode pool.

:class:`AutoscaleController` closes the loop between the
:class:`repro_torch.serving.DisaggregatedEngine` front-end's queue-depth
telemetry (the ``stats().depth_summary()`` signal) and its elastic
pool API (``add_decode / retire_decode / reap_retired``):

* **grow** — the depth histograms are cumulative and monotone, so the
  controller diffs their ``(count, total)`` pairs between steps to get
  the *windowed* mean backlog since the last look.  The watched signal
  is the sum of the ``"handoff"`` and ``"decode"`` phases by default:
  the front-end drains its handoff queue eagerly into the decode
  engines' admission queues, so sustained pressure lives in the
  combined backlog awaiting decode service, wherever it is parked.  A
  window mean at or above ``grow_depth`` marks the step hot;
  ``hot_steps`` consecutive hot steps (sustained pressure, not a
  one-tick blip) grow the pool by one engine from ``engine_factory``,
  up to ``max_engines``.
* **shrink** — a window whose mean backlog is at or below ``idle_depth``
  (engines keeping up: nothing queues, even if requests are resident
  and being served) marks the step idle; ``idle_steps`` consecutive
  idle steps drain the newest live engine (``retire_decode`` — resident
  requests finish normally, no new handoffs route to it), down to
  ``min_engines``.  Draining engines are reaped (removed) once empty on
  a later step.  Windows between the two thresholds reset both
  counters: only *sustained* evidence moves the pool.

Every action is recorded as a :class:`ScaleEvent`, and the controller
integrates live-engine-count over time so a replay can report the mean
pool size — the number the autoscale acceptance test compares against
a static max-size pool.  The controller is engine-agnostic beyond the
pool surface and deterministic: no internal clock, no randomness; the
caller supplies ``now`` (virtual or wall).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["ScaleEvent", "AutoscaleController"]


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One pool action: ``grow`` (engine joined), ``drain`` (engine
    began retiring) or ``reap`` (drained engine removed), with the live
    count *after* the action."""

    t: float
    action: str                       # "grow" | "drain" | "reap"
    n_live: int


class AutoscaleController:
    """Depth-signal autoscaler over a ``DisaggregatedEngine`` pool.

    ``engine_factory`` builds one ready decode engine per grow (the
    controller warms it up before joining).  Thresholds are in queue
    depth (requests parked in the handoff queue); steps are whatever
    cadence the caller drives — the replay loop steps once per engine
    tick.
    """

    def __init__(self, engine_factory: Callable[[], Any],
                 min_engines: int = 1, max_engines: int = 4,
                 grow_depth: float = 2.0, idle_depth: float = 0.0,
                 hot_steps: int = 3, idle_steps: int = 50,
                 warmup: bool = False,
                 signal: Tuple[str, ...] = ("handoff", "decode")):
        if min_engines < 1 or max_engines < min_engines:
            raise ValueError("need 1 <= min_engines <= max_engines")
        if hot_steps < 1 or idle_steps < 1:
            raise ValueError("hot_steps and idle_steps must be >= 1")
        if not idle_depth < grow_depth:
            raise ValueError("need idle_depth < grow_depth")
        self.engine_factory = engine_factory
        self.min_engines = int(min_engines)
        self.max_engines = int(max_engines)
        self.grow_depth = float(grow_depth)
        self.idle_depth = float(idle_depth)
        self.hot_steps = int(hot_steps)
        self.idle_steps = int(idle_steps)
        self.warmup = bool(warmup)
        self.signal = tuple(signal)
        self.events: List[ScaleEvent] = []
        self._hot = 0
        self._idle = 0
        self._last: Tuple[int, int] = (0, 0)   # (count, total) watermark
        self._live_integral = 0.0     # integral of n_live over time
        self._span_s = 0.0            # total stepped interval
        self._t_prev: Optional[float] = None

    # -- telemetry ---------------------------------------------------------

    def _window_depth(self, pool: Any) -> Optional[float]:
        """Mean watched backlog since the previous step, from the
        monotone cumulative depth histograms (``None`` when no new
        ticks recorded depth — nothing to conclude from an empty
        window).  The watched phases are recorded at the same ticks, so
        one phase's count is the shared tick counter."""
        depth = pool.stats().depth
        hists = [depth[k] for k in self.signal if k in depth]
        if not hists:
            return None
        count = int(hists[0].count)
        total = sum(int(h.total) for h in hists)
        dc = count - self._last[0]
        dt = total - self._last[1]
        self._last = (count, total)
        if dc <= 0:
            return None
        return dt / dc

    def mean_live(self) -> Optional[float]:
        """Time-averaged live-engine count over the stepped interval."""
        if self._span_s <= 0:
            return None
        return self._live_integral / self._span_s

    # -- control loop ------------------------------------------------------

    def step(self, pool: Any, now: float) -> Optional[ScaleEvent]:
        """One control decision; returns the event if the pool changed
        membership this step (reaps of previously-drained engines do
        not preempt a grow/drain decision — both can be recorded)."""
        # time-integrate the live count (for mean pool size reporting)
        n_live = pool.n_live_decodes
        if self._t_prev is not None:
            dt = max(now - self._t_prev, 0.0)
            self._live_integral += n_live * dt
            self._span_s += dt
        self._t_prev = now

        for _ in pool.reap_retired():
            self.events.append(ScaleEvent(t=now, action="reap",
                                          n_live=pool.n_live_decodes))

        depth = self._window_depth(pool)
        if depth is not None:
            if depth >= self.grow_depth:
                self._hot += 1
                self._idle = 0
            elif depth <= self.idle_depth:
                self._idle += 1
                self._hot = 0
            else:                     # between thresholds: no evidence
                self._hot = 0
                self._idle = 0
        elif pool.n_pending == 0:     # no ticks recorded, truly idle
            self._idle += 1
            self._hot = 0

        event: Optional[ScaleEvent] = None
        if self._hot >= self.hot_steps \
                and pool.n_live_decodes < self.max_engines:
            eng = self.engine_factory()
            if self.warmup:
                eng.warmup()
            pool.add_decode(eng)
            self._hot = 0
            event = ScaleEvent(t=now, action="grow",
                               n_live=pool.n_live_decodes)
        elif self._idle >= self.idle_steps \
                and pool.n_live_decodes > self.min_engines:
            if pool.retire_decode() is not None:
                event = ScaleEvent(t=now, action="drain",
                                   n_live=pool.n_live_decodes)
            self._idle = 0
        if event is not None:
            self.events.append(event)
        return event

"""SLO-aware admission control (explicit backpressure, never silent).

:class:`SLOAdmission` is the arrival-side gate the replay loop consults
before submitting each request: it projects what latency a new request
of the event's class would likely see given the engine's *observed*
per-class p95 and its current backlog, and rejects the request when the
projection clearly busts the class SLO.  Rejection is a first-class
outcome (the replay counts it as ``rejected`` and reports it) — the
alternative, admitting work that cannot meet its deadline, both wastes
capacity and drags down requests that could have met theirs.

The projection is deliberately simple and conservative::

    projected_p95 = observed_p95 * (1 + backlog / capacity)

i.e. the observed tail stretched by how many engine-loads of work are
already queued ahead.  Until a class has ``min_observations``
completions the gate admits unconditionally (no SLO evidence yet), and
classes without an SLO (``slo_p95_ms=None``) are always admitted —
best-effort traffic is shed by priority scheduling, not at the door.
An optional hard ``max_backlog`` rejects any SLO-bearing class beyond
that queue depth even before latency evidence accumulates.

Paged engines (``repro_torch.serving.pages``) add a memory signal: when the
engine exposes ``free_pages`` / ``total_pages`` (non-None only for a
paged cache), the effective capacity in the projection is scaled by the
pool's free-page headroom — a nearly-full pool means admitted requests
will wait on page churn (prefix-cache eviction, preemption spills)
beyond what queue depth shows, and a pool with *no* allocatable page
sheds SLO-bearing arrivals outright.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["SLOAdmission"]


class SLOAdmission:
    """Reject arrivals whose class SLO is already unattainable."""

    def __init__(self, max_backlog: Optional[int] = None,
                 min_observations: int = 8, slack: float = 1.0):
        """``slack`` scales the SLO before comparison (>1 admits more,
        <1 sheds earlier); ``max_backlog`` is an optional hard queue cap
        for SLO-bearing classes."""
        if min_observations < 1:
            raise ValueError("min_observations must be >= 1")
        if slack <= 0:
            raise ValueError("slack must be > 0")
        self.max_backlog = max_backlog
        self.min_observations = int(min_observations)
        self.slack = float(slack)
        self.rejected = 0
        self.admitted = 0

    def admit(self, engine: Any, event: Any, cls: Any,
              now: float) -> bool:
        """True to submit, False to shed.  Signature matches the replay
        loop's ``admission.admit(engine, event, cls, now)`` call."""
        slo = getattr(cls, "slo_p95_ms", None)
        if slo is None:
            self.admitted += 1
            return True
        backlog = int(getattr(engine, "n_pending", 0))
        capacity = max(int(getattr(engine, "capacity", 1)), 1)
        if self.max_backlog is not None and backlog > self.max_backlog:
            self.rejected += 1
            return False
        free = getattr(engine, "free_pages", None)
        total = getattr(engine, "total_pages", None)
        headroom = 1.0
        if free is not None and total:
            if free <= 0:
                # page pool exhausted: nothing can even prefill
                self.rejected += 1
                return False
            headroom = max(min(free / total, 1.0), 1e-6)
        st = engine.stats()
        # engines key latency by workload request class (e.g. "lm/p8");
        # pool all observed classes — the queue ahead of a new arrival
        # is shared, so the pooled tail is the right congestion signal
        count = sum(h.count for h in st.latency.values())
        if count < self.min_observations:
            self.admitted += 1
            return True
        p95 = max(h.p95_ms for h in st.latency.values())
        projected = p95 * (1.0 + backlog / (capacity * headroom))
        if projected > float(slo) * self.slack:
            self.rejected += 1
            return False
        self.admitted += 1
        return True

"""Arrival-trace generation: deterministic, seeded, class-mixed.

A :class:`Trace` is a sorted list of :class:`TraceEvent`\\ s — *when* a
request arrives, *which* :class:`RequestClass` it belongs to, and a
per-event ``seed`` that fully determines the request payload.  The
generators draw every random quantity (inter-arrival gaps, class picks,
per-event seeds, burst dwell times) from one explicit
``numpy.random.Generator``, so the same seed always yields the same
trace, and replaying the same trace always materialises the same
request objects — determinism is the contract, not a best effort.

Two arrival processes:

* :func:`poisson_trace` — homogeneous Poisson arrivals (exponential
  inter-arrival gaps at a single ``rate``), the steady-state baseline.
* :func:`bursty_trace` — a Markov-modulated Poisson process (MMPP): the
  trace alternates between *states* (e.g. calm / burst), each an
  exponential-dwell segment emitting Poisson arrivals at its own rate.
  This is the canonical open-loop model of bursty serving traffic and
  is what exercises autoscaling (sustained backlog during a burst,
  idle capacity after it).

Payload materialisation is separate from arrival generation:
:func:`build_lm_request` / :func:`build_image_request` turn one event
into a concrete engine request using only ``event.seed``, so a trace
can be generated once and replayed against any engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "RequestClass", "TraceEvent", "Trace",
    "poisson_trace", "bursty_trace",
    "build_lm_request", "build_image_request", "default_classes",
]


def _as_rng(seed: Union[int, np.random.Generator]) -> np.random.Generator:
    """Accept an int seed or a ready Generator (never global state)."""
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(int(seed))


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One stream of requests sharing shape, priority and SLO.

    ``kind`` selects the payload builder (``"lm"`` token sequences or
    ``"image"`` frame batches); the ``(lo, hi)`` ranges are inclusive
    and sampled per event from the event's own seed.  ``priority``
    follows the scheduler convention (0 = most urgent).  ``slo_p95_ms``
    is the class's latency target — ``None`` means best-effort; the
    admission controller and the replay report both read it.
    """

    name: str
    weight: float = 1.0               # relative arrival share
    kind: str = "lm"                  # "lm" | "image"
    prompt_len: Tuple[int, int] = (4, 16)       # lm: tokens (inclusive)
    max_new_tokens: Tuple[int, int] = (8, 16)   # lm: decode budget
    frames: Tuple[int, int] = (1, 4)            # image: frames/request
    priority: int = 0                 # 0 = most urgent
    slo_p95_ms: Optional[float] = None

    def __post_init__(self):
        if self.kind not in ("lm", "image"):
            raise ValueError(f"unknown request kind {self.kind!r}")
        if self.weight <= 0:
            raise ValueError("class weight must be > 0")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: time (seconds from trace start), class name, and the
    seed that fully determines the request payload."""

    t: float
    cls: str
    seed: int


@dataclasses.dataclass
class Trace:
    """A finite arrival schedule over a fixed class mix.

    ``events`` are sorted by arrival time; ``classes`` maps class name
    to its definition; ``horizon`` is the generation window in seconds
    (events never exceed it).  Traces are plain data — picklable,
    comparable, and independent of any engine.
    """

    events: List[TraceEvent]
    classes: Dict[str, RequestClass]
    horizon: float

    def __len__(self) -> int:
        return len(self.events)

    def class_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {c: 0 for c in self.classes}
        for e in self.events:
            out[e.cls] += 1
        return out

    def rate(self) -> float:
        """Mean arrival rate (events per second) over the horizon."""
        return len(self.events) / self.horizon if self.horizon > 0 else 0.0


def default_classes() -> List[RequestClass]:
    """The stock short/long + priority mix used by benchmarks and the
    launcher: interactive short prompts (tight SLO, urgent) alongside
    batch long prompts (loose SLO, deferrable)."""
    return [
        RequestClass("short", weight=3.0, prompt_len=(2, 8),
                     max_new_tokens=(4, 8), priority=0, slo_p95_ms=2000.0),
        RequestClass("long", weight=1.0, prompt_len=(12, 24),
                     max_new_tokens=(12, 24), priority=1,
                     slo_p95_ms=10000.0),
    ]


def _emit_events(ts: Sequence[float], classes: Sequence[RequestClass],
                 rng: np.random.Generator) -> List[TraceEvent]:
    """Attach a weighted class pick and a payload seed to each arrival
    time.  Draw order is fixed (class then seed, per event) so the
    event list is a pure function of the arrival times and rng state."""
    names = [c.name for c in classes]
    w = np.asarray([c.weight for c in classes], np.float64)
    p = w / w.sum()
    out = []
    for t in ts:
        cls = names[int(rng.choice(len(names), p=p))]
        seed = int(rng.integers(0, 2 ** 31 - 1))
        out.append(TraceEvent(t=float(t), cls=cls, seed=seed))
    return out


def _check_classes(classes: Sequence[RequestClass]) -> Dict[str, RequestClass]:
    if not classes:
        raise ValueError("need at least one RequestClass")
    by_name = {c.name: c for c in classes}
    if len(by_name) != len(classes):
        raise ValueError("duplicate class names")
    return by_name


def poisson_trace(classes: Sequence[RequestClass], rate: float,
                  horizon: float,
                  seed: Union[int, np.random.Generator] = 0) -> Trace:
    """Homogeneous Poisson arrivals at ``rate`` req/s for ``horizon``
    seconds.  Fully deterministic given ``seed``."""
    if rate <= 0 or horizon <= 0:
        raise ValueError("rate and horizon must be > 0")
    by_name = _check_classes(classes)
    rng = _as_rng(seed)
    ts, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= horizon:
            break
        ts.append(t)
    return Trace(events=_emit_events(ts, classes, rng), classes=by_name,
                 horizon=float(horizon))


def bursty_trace(classes: Sequence[RequestClass],
                 rates: Sequence[float], dwell: Sequence[float],
                 horizon: float,
                 seed: Union[int, np.random.Generator] = 0) -> Trace:
    """Markov-modulated Poisson arrivals (MMPP).

    The process holds in state ``i`` for an exponential dwell with mean
    ``dwell[i]`` seconds, emitting Poisson arrivals at ``rates[i]``
    req/s, then transitions: with two states it alternates (the classic
    on/off burst model); with more it jumps uniformly to another state.
    A rate of 0 is a silent state (pure gap).  Deterministic given
    ``seed``.
    """
    if len(rates) != len(dwell) or len(rates) < 2:
        raise ValueError("need >= 2 (rate, dwell) state pairs")
    if min(rates) < 0 or any(r <= 0 for r in dwell) or horizon <= 0:
        raise ValueError("rates must be >= 0, dwells and horizon > 0")
    if max(rates) <= 0:
        raise ValueError("at least one state must have rate > 0")
    by_name = _check_classes(classes)
    rng = _as_rng(seed)
    ts: List[float] = []
    t, state = 0.0, 0
    while t < horizon:
        seg_end = min(t + float(rng.exponential(dwell[state])), horizon)
        r = rates[state]
        if r > 0:
            tt = t
            while True:
                tt += float(rng.exponential(1.0 / r))
                if tt >= seg_end:
                    break
                ts.append(tt)
        t = seg_end
        if len(rates) == 2:
            state = 1 - state
        else:
            step = 1 + int(rng.integers(0, len(rates) - 1))
            state = (state + step) % len(rates)
    return Trace(events=_emit_events(ts, classes, rng), classes=by_name,
                 horizon=float(horizon))


def build_lm_request(event: TraceEvent, cls: RequestClass,
                     vocab: int = 256, stream: bool = False):
    """Materialise one LM request from an event: prompt tokens, decode
    budget and priority are all drawn from ``event.seed`` alone, so the
    same event always builds the same request on any engine."""
    from repro_torch.serving.engine import Request
    if cls.kind != "lm":
        raise ValueError(f"class {cls.name!r} is not an lm class")
    rng = np.random.default_rng(event.seed)
    plen = int(rng.integers(cls.prompt_len[0], cls.prompt_len[1] + 1))
    prompt = rng.integers(1, max(vocab, 2), size=max(plen, 1)).tolist()
    mnt = int(rng.integers(cls.max_new_tokens[0],
                           cls.max_new_tokens[1] + 1))
    return Request(prompt=[int(x) for x in prompt], max_new_tokens=mnt,
                   priority=cls.priority, stream=stream)


def build_image_request(event: TraceEvent, cls: RequestClass,
                        shape: Tuple[int, int, int] = (28, 28, 1),
                        stream: bool = False):
    """Materialise one image-classification request (frame batch) from
    an event, deterministic in ``event.seed``."""
    from repro_torch.serving.capsule_engine import ImageRequest
    if cls.kind != "image":
        raise ValueError(f"class {cls.name!r} is not an image class")
    rng = np.random.default_rng(event.seed)
    n = int(rng.integers(cls.frames[0], cls.frames[1] + 1))
    images = rng.standard_normal((max(n, 1),) + tuple(shape))
    return ImageRequest(images=np.asarray(images, np.float32),
                        stream=stream)

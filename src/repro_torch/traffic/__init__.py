"""``repro_torch.traffic`` — deterministic traffic generation, replay and
closed-loop control for the serving engines.

Three layers, each usable alone:

* **Traces** (:mod:`repro_torch.traffic.traces`) — :func:`poisson_trace` and
  :func:`bursty_trace` (Markov-modulated Poisson) generate
  :class:`Trace` arrival schedules over a mix of
  :class:`RequestClass`\\ es (short/long prompts, LM vs image frames,
  per-class priority and SLO), fully deterministic from one explicit
  seed.
* **Replay** (:mod:`repro_torch.traffic.replay`) — :func:`replay` drives any
  engine with the standard ``submit()/poll()/tick()`` surface through a
  trace on a :class:`VirtualClock`, producing a :class:`ReplayReport`
  (counts, per-class latency, the exact schedule).
* **Control** (:mod:`repro_torch.traffic.controller` /
  :mod:`repro_torch.traffic.admission`) — :class:`AutoscaleController` grows
  and drains a :class:`repro_torch.serving.DisaggregatedEngine` decode pool on
  the handoff queue-depth signal; :class:`SLOAdmission` sheds arrivals
  whose class SLO is already unattainable.

The package is numpy and Python; it reaches the serving engines only
through their ``submit() / poll() / tick() / stats()`` surface and the
disaggregated pool's elastic API, and materialises requests as
:class:`repro_torch.serving.Request` /
:class:`repro_torch.serving.ImageRequest`.
"""

from repro_torch.traffic.admission import SLOAdmission  # noqa: F401
from repro_torch.traffic.controller import (  # noqa: F401
    AutoscaleController, ScaleEvent)
from repro_torch.traffic.replay import (  # noqa: F401
    ReplayReport, VirtualClock, default_factory, replay)
from repro_torch.traffic.traces import (  # noqa: F401
    RequestClass, Trace, TraceEvent, build_image_request, build_lm_request,
    bursty_trace, default_classes, poisson_trace)

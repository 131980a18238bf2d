"""``repro_torch.serving`` — the unified async serving engine API.

One :class:`EngineCore` owns slot state, fixed-shape ticks, streaming
results and cumulative stats (with per-request-class latency and
per-phase queue-depth histograms); pluggable :class:`Scheduler`s decide
admission, batch shape, device placement and tick interleaving;
:class:`CapsuleEngine` (CapsNet image frames, the paper's Fig. 1 workload)
and :class:`ServeEngine` (LM decode over dense slot caches or the paged
:class:`PagePool`) are the workload adapters, with the ``submit() / poll()
/ run_until_idle() / stats()`` surface and true async admission.  The
disaggregated front-end and the sharded scheduler are not ported yet.
"""

from repro_torch.serving.capsule_engine import (CapsuleEngine,  # noqa: F401
                                                ImageCompletion, ImageRequest)
from repro_torch.serving.core import (DepthHistogram,  # noqa: F401
                                      EngineCore, EngineStats,
                                      LatencyHistogram, SlotTask, StreamEvent)
from repro_torch.serving.engine import (Completion, Request,  # noqa: F401
                                        ServeEngine)
from repro_torch.serving.pages import (PagePool,  # noqa: F401
                                       PagePoolExhausted)
from repro_torch.serving.schedulers import (DisaggScheduler,  # noqa: F401
                                            FIFOScheduler,
                                            InterleavingScheduler,
                                            PriorityScheduler, Scheduler,
                                            SLOBatchScheduler, TickRecord,
                                            pow2_bucket)

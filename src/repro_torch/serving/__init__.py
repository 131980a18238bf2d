"""``repro_torch.serving`` — the unified async serving engine API.

One :class:`EngineCore` owns slot state, fixed-shape ticks, streaming
results and cumulative stats (with per-request-class latency and
per-phase queue-depth histograms); pluggable :class:`Scheduler`s decide
admission, batch shape, device placement and tick interleaving;
:class:`CapsuleEngine` (CapsNet image frames, the paper's Fig. 1 workload)
and :class:`ServeEngine` (LM decode over dense slot caches or the paged
:class:`PagePool`) are the workload adapters, with the ``submit() / poll()
/ run_until_idle() / stats()`` surface and true async admission.
:class:`DisaggregatedEngine` (``repro_torch.serving.disagg``) keeps that
same surface while splitting prefill and decode onto dedicated engines
joined by typed :class:`CacheHandoff`\\ s, whose rows a swappable
:class:`Transport` (``repro_torch.serving.transport``) delivers; with
``prefill=None`` it load-balances over a pool of :class:`CapsuleEngine`\\ s.
The sharded scheduler and the multi-host disaggregated engine are not
ported yet.
"""

from repro_torch.serving.capsule_engine import (CapsuleEngine,  # noqa: F401
                                                ImageCompletion, ImageRequest)
from repro_torch.serving.core import (DepthHistogram,  # noqa: F401
                                      EngineCore, EngineStats,
                                      LatencyHistogram, SlotTask, StreamEvent)
from repro_torch.serving.disagg import (CacheHandoff,  # noqa: F401
                                        DecodeEngine, DisaggregatedEngine,
                                        HandoffRequest, PrefillEngine,
                                        disaggregated_lm_engine)
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
from repro_torch.serving.transport import (  # noqa: F401
    DeviceToDeviceTransport, HostStagedTransport, InProcessTransport,
    TransferRecord, Transport, TransportError, make_transport,
    select_transport)

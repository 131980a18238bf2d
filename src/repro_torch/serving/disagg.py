"""Disaggregated prefill: admission/prefill and decode on separate engines.

The :class:`repro_torch.serving.InterleavingScheduler` separates prefill
from decode *in time* — dedicated ticks on one engine.  This module
separates them *across engines*: a :class:`PrefillEngine` owns admission
and the compute-bound ragged prefill, one or more :class:`DecodeEngine`\\ s
own the memory-bound token loop, and finished prefill state moves between
them as a typed :class:`CacheHandoff` (slot-axis gather on the prefill
side -> transport -> scatter into the decode engine's slot).

The moving parts:

  * :class:`CacheHandoff` — the typed contract between the two sides:
    per-request cache rows (gathered with ``lm.gather_cache_rows``, or the
    slot's pages for a paged cache), the pending token/position, the
    partial output, the sampling state, and the model signature the decode
    side validates against (family/arch/cache geometry/dtypes) so a
    mis-routed handoff fails loudly instead of decoding garbage.
  * :class:`PrefillEngine` — a :class:`repro_torch.serving.ServeEngine`
    whose slots live exactly one admission: every request finishes *at
    prefill* and completes with a ``CacheHandoff`` instead of tokens.
  * :class:`DecodeEngine` — a :class:`repro_torch.serving.ServeEngine`
    that admits ``CacheHandoff``\\ s: injection scatters the rows into its
    own slot caches (``lm.scatter_cache_rows``) or splices the pages into
    its pool.
  * :class:`DisaggregatedEngine` — the front-end that keeps the standard
    ``submit() / poll() / run_until_idle() / stats()`` surface (including
    ``poll(stream=True)`` ordering across the handoff boundary), drives
    the three stages under a scheduler whose ``phase()`` may answer
    ``"handoff"``, moves each handoff's rows through a
    :class:`repro_torch.serving.Transport`, fails a handoff over to
    another decode engine when one dies mid-transfer (requeued, never
    dropped), and reports per-phase queue-depth and transfer-latency
    histograms through :class:`repro_torch.serving.EngineStats`.

Disaggregated serving is **exact**: prefill uses the same ragged admission
as the unified engine, and the gathered rows are the same state, so the
decoded tokens match per-request ``generate()``.  The port serves the
dense, moe, vlm, ssm and hybrid families (a vlm handoff carries its nested
``{"units": {"kv", "cross"}}`` rows whole, or its pages plus the cross
cache as residual rows; an ssm or hybrid handoff carries its float32
recurrent state rows, gathered and scattered along each leaf's own batch
axis, with the hybrid's shared-attention KV rows beside them).
:func:`multihost_disaggregated_lm_engine` puts the prefill engine and each
decode engine on a mesh of its own (disjoint device groups, each engine
data-parallel over its group); a handoff's rows then travel to the decode
engine's first device, and its admission moves them to the device of the
slot they are injected into.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serving.core import (DepthHistogram, EngineCore, EngineStats,
                                      LatencyHistogram, SlotTask, StreamEvent,
                                      allocate_rid)
from repro_torch.serving.engine import ServeEngine, _to_device
from repro_torch.serving.pages import PagePool
from repro_torch.serving.schedulers import (DisaggScheduler, Scheduler,
                                            ShardedScheduler)
from repro_torch.serving.transport import (InProcessTransport, Transport,
                                           make_transport, select_transport,
                                           wait_ready)


@dataclasses.dataclass
class CacheHandoff:
    """Per-request decode state handed from a prefill to a decode engine.

    ``rows`` is a ``lm.make_caches(cfg, 1, max_len)``-shaped tree — one
    slot's gathered cache rows (``None`` when ``done``: the request
    finished at prefill and only needs its completion emitted, or when
    ``stateless``: a dispatch-only handoff for workloads with no carried
    state, e.g. image frames).  ``family`` / ``arch_id`` / ``max_len``
    plus the rows' tree/shape/dtypes are the signature
    :meth:`DecodeEngine.validate_handoff` checks before admitting.
    """

    rid: int
    request: Any                      # the original workload request
    family: Optional[str]             # LM family (None: stateless workload)
    arch_id: Optional[str]
    max_len: int
    rows: Any                         # cache tree with batch dim 1, or None
    tok: int                          # pending token to feed the next decode
    pos: int                          # its cache index
    out: List[int]                    # prompt + tokens generated so far
    left: int                         # tokens still to generate
    done: bool = False                # finished at prefill; no decode needed
    stateless: bool = False           # dispatch-only (no carried state)
    stream: bool = False              # original request opted into streaming
    cls: str = "default"              # request class (latency histograms)
    t_handoff: float = 0.0            # when the handoff entered the queue
    # sampling state travels typed with the handoff: the seed was fixed at
    # prefill admission (engine._bind_seed), so the decode side draws the
    # exact same counter-based sequence a unified engine would
    seed: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # paged handoffs (repro_torch.serving.pages): ``rows`` becomes
    # ``{"pages": export_pages payload, "residual": residual rows}``.
    # ``page_hashes`` advertises the prefix-index identity of each page
    # (None = private) so the front-end can pin target-side hits and strip
    # them from the payload — a handoff then moves only the pages the
    # target doesn't already hold, plus an O(pages) table splice.
    paged: bool = False
    page_size: int = 0
    quantized: bool = False
    n_pages: int = 0                  # pages in the slot's table at export
    page_hashes: Optional[List[Optional[bytes]]] = None
    page_missing: Optional[List[int]] = None   # positions in rows["pages"]
    page_pinned: Optional[Dict[int, int]] = None  # target pos -> pinned page
    # the CUDA event of a device-to-device copy still writing ``rows``
    # (repro_torch.serving.DeviceToDeviceTransport); the decode engine's
    # stream waits on it before reading them
    ready: Any = None


@dataclasses.dataclass
class HandoffRequest:
    """What a :class:`DisaggregatedEngine` submits to a decode engine: one
    :class:`CacheHandoff` wrapped in the standard request shape (``rid`` /
    ``stream``), so it flows through the ordinary ``EngineCore.submit``
    path and slot admission."""

    handoff: CacheHandoff
    rid: Optional[int] = None
    stream: bool = False

    @property
    def temperature(self) -> float:
        """Sampling temperature travels typed on the handoff."""
        return float(self.handoff.temperature)

    @property
    def seed(self) -> int:
        """The request's sampling seed — never None past prefill."""
        return int(self.handoff.seed)

    @property
    def top_k(self) -> int:
        return int(self.handoff.top_k)

    @property
    def top_p(self) -> float:
        return float(self.handoff.top_p)

    @property
    def priority(self) -> int:
        """Priority class travels with the original request, so a
        :class:`repro_torch.serving.PriorityScheduler` on a decode engine
        can preempt across the handoff boundary."""
        return int(getattr(self.handoff.request, "priority", 0))


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Any, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (i,))]
    return [(path, tree)]


class PrefillEngine(ServeEngine):
    """Admission/prefill half of a disaggregated pair.

    A :class:`repro_torch.serving.ServeEngine` whose slots live exactly one
    admission tick: after the ragged batched prefill of
    ``ServeEngine._admit``, every admitted slot's cache rows are gathered
    out (``lm.gather_cache_rows`` on the slot axis, or the slot's pages)
    and the request *completes* — its completion object is a
    :class:`CacheHandoff`, not tokens.  ``max_new_tokens <= 0`` requests
    still complete with an identity :class:`repro_torch.serving.Completion`.

    The engine itself never streams (``_wants_stream`` is pinned False);
    the handoff carries the request's ``stream`` flag so token events start
    on the decode side with ``seq=0`` at the prefill-sampled first token —
    the same numbering a unified engine emits.
    """

    def _wants_stream(self, request: Any) -> bool:
        return False                  # streaming starts on the decode side

    def _admit(self, new: List[Tuple[int, SlotTask]]
               ) -> Tuple[List[int], int]:
        finished, items = super()._admit(new)
        done = set(finished)
        for s, task in new:
            req = task.payload
            task.state["handoff"] = CacheHandoff(
                rid=task.rid, request=req,
                family=self.cfg.family, arch_id=self.cfg.arch_id,
                max_len=self.max_len, rows=None,
                tok=int(self._tok[s]), pos=int(self._pos[s]),
                out=list(task.state["out"]), left=int(task.state["left"]),
                done=(s in done),
                stream=bool(getattr(req, "stream", False)),
                cls=self._request_class(req),
                seed=int(getattr(req, "seed", None) or 0),
                temperature=float(getattr(req, "temperature", 0.0)),
                top_k=int(getattr(req, "top_k", 0) or 0),
                top_p=float(getattr(req, "top_p", 1.0)))
        # one batched slot-axis gather for the whole admission (not one per
        # request), then a per-request split of the gathered rows
        pending = [(s, task) for s, task in new
                   if not task.state["handoff"].done]
        if pending and self._pages is not None:
            # paged export: one page copy per block for the whole group,
            # split per slot.  Slots retire right after this, so registered
            # pages demote to *cached* on the prefill pool — a later
            # request with the same prompt prefix still hits.
            for sh, members in self._by_shard(pending):
                per_slot = [self._pages.slot_pages(s) for s, _ in members]
                flat = [p for ids in per_slot for p in ids]
                payload = self._pages.export_pages(
                    sh.pool, self._local_pages(sh, flat))
                res_all = self._pages.gather_residual_rows(
                    sh.residual, [s - sh.lo for s, _ in members])
                base = 0
                for i, (s, task) in enumerate(members):
                    h = task.state["handoff"]
                    n = len(per_slot[i])
                    h.paged = True
                    h.page_size = self._pages.page_size
                    h.quantized = self._pages.quantize
                    h.n_pages = n
                    h.page_hashes = self._pages.slot_page_hashes(s)
                    h.page_missing = list(range(n))
                    h.rows = {
                        "pages": self._pages.take_payload(
                            payload, range(base, base + n)),
                        "residual": self._pages.gather_residual_rows(
                            res_all, [i]),
                    }
                    base += n
        elif pending:
            for sh, members in self._by_shard(pending):
                # one staged gather (the reference's _gather) per slot:
                # each handoff owns its rows, not a view that would hold
                # the whole group's rows until its last handoff is
                # delivered; k replays where the batched gather and its
                # k per-slot splits made k + 1 copies
                for s, task in members:
                    task.state["handoff"].rows = self._gather_rows(
                        sh, [s - sh.lo])
        # every admitted slot retires this tick: the slot's state left in
        # the handoff, the slot itself is free for the next admission
        return [s for s, _ in new], items

    def _finalize(self, entry, latency_s: float):
        if not entry.tasks:           # max_new_tokens <= 0: identity
            return super()._finalize(entry, latency_s)
        return entry.tasks[0].state["handoff"]


class DecodeEngine(ServeEngine):
    """Decode half of a disaggregated pair.

    A :class:`repro_torch.serving.ServeEngine` that admits
    :class:`HandoffRequest`\\ s: ``submit`` validates the handoff signature
    (family/arch/cache geometry/dtypes — a mismatch raises ``ValueError``
    before any engine state changes, never decodes garbage), and admission
    *injects* instead of prefilling — the rows scatter into this engine's
    slot caches at the assigned slot (after waiting for a device-to-device
    copy still writing them), or a paged handoff's pages splice into its
    pool.  Plain :class:`repro_torch.serving.Request`\\ s are still accepted
    (it remains a full ServeEngine), so a decode engine can drain mixed
    traffic.  A preempted handoff resumes from its own saved rows, like
    any preempted request.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # this engine's per-slot cache geometry: make_caches on the meta
        # device allocates nothing
        self._expected_rows = [
            (path, (tuple(x.shape), x.dtype)) for path, x in _flatten(
                lm.make_caches(self.cfg, 1, self.max_len, device="meta"))]

    def validate_handoff(self, h: CacheHandoff) -> None:
        """Raise ``ValueError`` unless ``h`` can be decoded *exactly* by
        this engine: same model family and arch, same cache length, and
        cache rows whose tree/shape/dtypes match this engine's own
        ``lm.make_caches`` geometry."""
        if h.family != self.cfg.family or h.arch_id != self.cfg.arch_id:
            raise ValueError(
                f"cache handoff rid={h.rid} was prefilled by model "
                f"family={h.family!r} arch={h.arch_id!r}; this decode "
                f"engine runs family={self.cfg.family!r} "
                f"arch={self.cfg.arch_id!r} — decoding it would produce "
                f"garbage, refusing")
        if h.max_len != self.max_len:
            raise ValueError(
                f"cache handoff rid={h.rid} carries max_len={h.max_len} "
                f"cache rows; this decode engine's slots are "
                f"max_len={self.max_len} — shapes cannot line up")
        if h.done:
            return                    # no rows travel with a done handoff
        if h.paged != (self._pages is not None):
            raise ValueError(
                f"cache handoff rid={h.rid} is "
                f"{'paged' if h.paged else 'dense'}; this decode engine's "
                f"cache is {'paged' if self._pages is not None else 'dense'}"
                f" — the layouts cannot splice")
        if h.paged:
            self._validate_paged(h)
            return
        got = _flatten(h.rows)
        want_paths = [p for p, _ in self._expected_rows]
        if [p for p, _ in got] != want_paths:
            raise ValueError(
                f"cache handoff rid={h.rid}: cache tree structure does not "
                f"match this engine's {self.cfg.family} cache "
                f"({[p for p, _ in got]} != {want_paths})")
        for (_, (shape, dtype)), (_, g) in zip(self._expected_rows, got):
            self._check_leaf(h.rid, "cache leaf", g, shape, dtype)

    @staticmethod
    def _check_leaf(rid: int, what: str, g: Any, shape: Tuple[int, ...],
                    dtype: torch.dtype) -> None:
        got_shape = tuple(getattr(g, "shape", ()))
        if got_shape != tuple(shape):
            raise ValueError(
                f"cache handoff rid={rid}: {what} shape {got_shape} != "
                f"expected {tuple(shape)}")
        if getattr(g, "dtype", None) != dtype:
            raise ValueError(
                f"cache handoff rid={rid}: {what} dtype "
                f"{getattr(g, 'dtype', None)} != expected {dtype}")

    def _validate_paged(self, h: CacheHandoff) -> None:
        """Paged half of :meth:`validate_handoff`: the page geometry and
        representation must agree exactly (hashes are only comparable
        between pools with identical seeds), and the travelling payload
        must match this pool's per-page leaf shapes/dtypes."""
        if (h.page_size != self._pages.page_size
                or h.quantized != self._pages.quantize):
            raise ValueError(
                f"cache handoff rid={h.rid} carries "
                f"page_size={h.page_size} quantized={h.quantized} pages; "
                f"this decode engine's pool is "
                f"page_size={self._pages.page_size} "
                f"quantized={self._pages.quantize} — page payloads and "
                f"prefix hashes are not interchangeable")
        missing = (h.page_missing if h.page_missing is not None
                   else list(range(h.n_pages)))
        covered = set(missing) | set(h.page_pinned or {})
        if covered != set(range(h.n_pages)):
            raise ValueError(
                f"cache handoff rid={h.rid}: travelling + pinned pages "
                f"cover positions {sorted(covered)}, need 0..{h.n_pages - 1}")
        want = dict(self._pages.page_payload_struct(len(missing)))
        want.update(self._pages.residual_rows_struct(1))
        got = {}
        if isinstance(h.rows, dict):
            got.update(h.rows.get("pages") or {})
            got.update(h.rows.get("residual") or {})
        if sorted(got) != sorted(want):
            raise ValueError(
                f"cache handoff rid={h.rid}: paged payload leaves "
                f"{sorted(got)} != expected {sorted(want)}")
        for k, (shape, dtype) in want.items():
            self._check_leaf(h.rid, f"paged leaf {k}", got[k], shape, dtype)

    # -- workload hooks ----------------------------------------------------

    def _expand(self, request: Any) -> Tuple[List[SlotTask], Dict[str, Any]]:
        if not isinstance(request, HandoffRequest):
            return super()._expand(request)
        self.validate_handoff(request.handoff)
        return [SlotTask(payload=request)], {}

    @staticmethod
    def _is_injection(task: SlotTask) -> bool:
        """A handoff task admitted for the first time (a preempted one
        carries its own saved state and resumes like any other task)."""
        return (isinstance(task.payload, HandoffRequest)
                and "out" not in task.state)

    def _admit(self, new: List[Tuple[int, SlotTask]]
               ) -> Tuple[List[int], int]:
        plain = [(s, t) for s, t in new if not self._is_injection(t)]
        hand = [(s, t) for s, t in new if self._is_injection(t)]
        finished, items = (super()._admit(plain) if plain else ([], 0))
        finished = list(finished)
        # one batched inject for the whole handoff group
        live = [(s, t.payload.handoff) for s, t in hand
                if not t.payload.handoff.done]
        for _, h in live:
            wait_ready(h)
        if live and self._pages is not None:
            self._admit_paged_handoffs(live)
        elif live:
            # each group's rows go to the device that owns its slots
            for sh, members in self._by_shard(live):
                self._inject_rows(sh, [s - sh.lo for s, _ in members],
                                  [_to_device(h.rows, sh.device)
                                   for _, h in members])
        for s, task in hand:
            h = task.payload.handoff
            h.rows = h.ready = None   # the state lives in this engine now
            task.state = {"out": list(h.out), "left": int(h.left)}
            self._tok[s] = h.tok
            self._pos[s] = h.pos
            # first token event: prefill sampled it, decode emits it, so
            # the stream starts at seq=0 exactly like a unified engine
            self._emit(task.rid, h.out[-1] if h.out else None)
            if h.left <= 0 or h.pos >= self.max_len:
                finished.append(s)
        return finished, items        # injected tokens were counted by
        #                               the prefill engine's stats

    def _admit_paged_handoffs(self, live: List[Tuple[int, CacheHandoff]]
                              ) -> None:
        """Splice a group of paged handoffs into this engine's pool: one
        batched ``import_pages`` for every travelling page in the group,
        front-end-pinned pages reused in place (their reference transfers
        to the slot binding), fresh pages registered under the hashes the
        prefill side advertised so *later* handoffs dedup against them."""
        for sh, members in self._by_shard(live):
            all_ids: List[int] = []
            all_payloads: List[Dict[str, Any]] = []
            for s, h in members:
                pinned = h.page_pinned or {}
                missing = (h.page_missing if h.page_missing is not None
                           else list(range(h.n_pages)))
                fresh = self._alloc_pages(len(missing), s)
                allp: List[int] = [-1] * h.n_pages
                for pos, pg in pinned.items():
                    allp[pos] = pg
                for j, pos in enumerate(missing):
                    allp[pos] = fresh[j]
                hashes = h.page_hashes or []
                for j, pos in enumerate(missing):
                    if pos < len(hashes) and hashes[pos] is not None:
                        self._pages.register_hash(fresh[j], hashes[pos])
                self._pages.bind_slot(s, allp)
                if fresh:
                    all_ids.extend(self._local_pages(sh, fresh))
                    all_payloads.append(h.rows["pages"])
            if all_ids:
                payload = {k: torch.cat([p[k].to(sh.device)
                                         for p in all_payloads])
                           for k in all_payloads[0]}
                sh.pool = self._pages.import_pages(sh.pool, payload,
                                                   all_ids)
            res = [_to_device(h.rows["residual"], sh.device)
                   for _, h in members]
            if res and self._pages.residual_specs():
                sh.residual = self._pages.scatter_residual_rows(
                    sh.residual, self._pages.concat_residual_rows(res),
                    np.asarray([s - sh.lo for s, _ in members], np.int32))

    def _request_class(self, request: Any) -> str:
        if isinstance(request, HandoffRequest):
            return request.handoff.cls
        return super()._request_class(request)


@dataclasses.dataclass
class _Tracked:
    """Front-end bookkeeping for one in-flight request."""

    t0: float                         # front-end submit wall-clock
    cls: str                          # request class (latency histogram)
    stream: bool


class DisaggregatedEngine:
    """Front-end over one prefill engine and N decode engines.

    Keeps the standard engine surface — ``submit() / poll() /
    run_until_idle() / stats() / warmup() / tick() / serve()`` — while
    requests flow prefill -> handoff queue -> decode.  Each ``tick()`` asks
    ``scheduler.phase()`` (default :class:`DisaggScheduler`) which stage to
    run: ``"prefill"`` ticks the prefill engine, ``"handoff"`` drains the
    handoff queue into decode engines, ``"decode"`` ticks the decode
    engines, ``"mixed"`` does all three.  Impossible answers are coerced
    exactly as :class:`repro_torch.serving.EngineCore` does, so no
    scheduler can stall the front-end.

    **Streaming** — ``poll(stream=True)`` relays the decode engines'
    :class:`repro_torch.serving.StreamEvent`\\ s: a request's whole stream
    comes from the one decode engine that owns it, so per-rid ``seq``
    ordering holds across the handoff boundary, and the ``done`` event
    carries the same completion object plain ``poll()`` returns (with
    end-to-end latency: front-end submit to final token).

    **Transport** — every rows-carrying handoff is *delivered* through a
    :class:`repro_torch.serving.Transport` before the decode submit, and
    the per-leg timings land in ``stats().transfer`` as
    ``"<transport>/<leg>"`` histograms plus a ``"<transport>/total"``
    critical-path histogram, next to the ``"handoff"`` queue-wait
    histogram.  ``transport`` accepts an instance, a name
    (``"in_process"`` / ``"host_staged"`` / ``"device_to_device"``), or
    ``"auto"`` (device-to-device when a decode engine's device differs
    from prefill's, else in-process).  Stateless dispatch-only handoffs
    carry no rows and bypass the transport.  When both sides run a paged
    cache, the payload is the slot's *pages*, and before delivery the
    front-end pins the target pool's prefix-index hits for the advertised
    page hashes and strips them from the payload (``stats().pages`` counts
    ``handoff_pages_moved`` / ``handoff_pages_dedup``).

    **Fault handling** — a decode engine whose transport delivery or
    ``submit`` raises during a handoff is marked dead and the handoff
    *requeues* onto the next engine (never dropped — a failed delivery
    leaves ``rows`` untouched, so the surviving route re-delivers the same
    state); a ``ValueError`` (typed handoff rejection) propagates instead,
    since it means a mis-built pair.  When every decode engine is dead the
    front-end raises rather than spin.

    **Elastic pool** — ``add_decode()`` joins a fresh engine,
    ``retire_decode()`` begins *draining* one (no new handoffs route to
    it; resident requests finish normally), and ``reap_retired()`` removes
    engines that finished draining.  Retired engines' work counters stay
    in the aggregated stats; ``retire_decode`` refuses to drain the last
    live engine.  :class:`repro_torch.traffic.AutoscaleController` drives
    these on the ``depth_summary()`` signal.

    **Stats** — aggregated :class:`repro_torch.serving.EngineStats`: items /
    ticks / wall-clock summed over the member engines, completion counts
    and end-to-end latency histograms owned by the front-end, plus
    per-phase queue-depth histograms (``depth``) and handoff
    transfer-latency histograms (``transfer``).

    ``prefill=None`` is the stateless degenerate form (no carried state,
    e.g. :class:`repro_torch.serving.CapsuleEngine` pools): submissions
    become dispatch-only handoffs and the front-end is a validating
    load-balancer with the same phase/stats machinery.
    """

    def __init__(self, prefill: Optional[EngineCore],
                 decodes: List[EngineCore],
                 scheduler: Optional[Scheduler] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 transport: Optional[Any] = None):
        if not decodes:
            raise ValueError("need at least one decode engine")
        self.prefill = prefill
        if transport is None:
            transport = InProcessTransport()
        elif transport == "auto":
            transport = select_transport(prefill, decodes)
        elif isinstance(transport, str):
            transport = make_transport(transport)
        elif not isinstance(transport, Transport):
            raise TypeError(f"transport must be a Transport instance or "
                            f"name, got {type(transport).__name__}")
        self.transport = transport    # set once here, never rebound
        self.decodes = list(decodes)              # guarded-by: _tick_lock
        self.capacity = sum(e.capacity            # guarded-by: _tick_lock
                            for e in self.decodes)
        self.scheduler = scheduler or DisaggScheduler()
        self.scheduler.bind(self)
        self._clock = clock
        self._handoffs: Deque[CacheHandoff] = deque()   # guarded-by: _lock
        self._inflight: Dict[int, _Tracked] = {}        # guarded-by: _lock
        self._completions: Deque[Any] = deque()         # guarded-by: _lock
        self._events: Deque[StreamEvent] = deque()      # guarded-by: _lock
        self._stats = EngineStats()                     # guarded-by: _lock
        self._next_rid = 0                              # guarded-by: _lock
        # engine-identity sets/lists (indices would go stale as the elastic
        # pool grows and shrinks): _dead = submit raised mid-handoff;
        # _draining = retiring, drains but takes no new work; _retired =
        # removed, stats retained
        self._dead: Set[EngineCore] = set()       # guarded-by: _tick_lock
        self._draining: Set[EngineCore] = set()   # guarded-by: _tick_lock
        self._retired: List[EngineCore] = []      # guarded-by: _tick_lock
        self._rr = 0    # round-robin cursor      # guarded-by: _tick_lock
        self._lock = threading.Lock()
        self._tick_lock = threading.Lock()

    # -- shared surface ----------------------------------------------------

    def submit(self, request: Any) -> int:
        """Enqueue one request (thread-safe, non-blocking); returns its
        rid.  Validation errors (malformed payloads) raise before any
        front-end or member-engine state changes."""
        front = self.prefill if self.prefill is not None else self.decodes[0]
        cls = front._request_class(request)
        stream = bool(getattr(request, "stream", False))
        with self._lock:
            rid, self._next_rid = allocate_rid(request, self._inflight,
                                               self._next_rid)
            # registered before the member submit: the ticker may finish
            # the request between that submit and any later bookkeeping
            self._inflight[rid] = _Tracked(t0=self._clock(), cls=cls,
                                           stream=stream)
        try:
            if self.prefill is not None:
                self.prefill.submit(request)
            else:
                self.decodes[0]._expand(request)   # validate eagerly
                with self._lock:
                    self._handoffs.append(CacheHandoff(
                        rid=rid, request=request, family=None, arch_id=None,
                        max_len=0, rows=None, tok=0, pos=0, out=[], left=0,
                        stateless=True, stream=stream, cls=cls,
                        t_handoff=self._clock()))
        except BaseException:
            with self._lock:
                self._inflight.pop(rid, None)
            raise
        return rid

    def poll(self, stream: bool = False) -> List[Any]:
        """Drain completions (or, with ``stream=True``, the relayed
        :class:`repro_torch.serving.StreamEvent`\\ s) ready so far — the
        same two-channel contract as
        :class:`repro_torch.serving.EngineCore`."""
        out: List[Any] = []
        with self._lock:
            src = self._events if stream else self._completions
            while src:
                out.append(src.popleft())
        return out

    def tick(self) -> bool:
        """One front-end step; returns False when every stage was idle."""
        with self._tick_lock:
            with self._lock:
                n_handoff = len(self._handoffs)
            n_prefill = self.prefill.n_pending if self.prefill else 0
            n_decode = sum(e.n_pending for e in self.decodes)
            sched = self.scheduler
            if hasattr(sched, "handoff_depth"):
                sched.handoff_depth = n_handoff
            phase = sched.phase(n_prefill + n_handoff, n_decode)
            if phase not in ("prefill", "handoff", "decode"):
                phase = "mixed"
            elif phase == "prefill" and (self.prefill is None
                                         or n_prefill == 0):
                phase = "mixed"
            elif phase == "handoff" and n_handoff == 0:
                phase = "mixed"
            elif phase == "decode" and n_decode == 0:
                phase = "mixed"
            if n_prefill or n_handoff or n_decode:
                # depth records *backlog awaiting service* (queue-only, the
                # same quantity EngineCore.tick records) — n_pending above
                # also counts residents, which phase decisions need but
                # depth histograms must not
                q_pre = self.prefill.n_queued if self.prefill else 0
                q_dec = sum(e.n_queued for e in self.decodes)
                with self._lock:
                    st = self._stats
                    if self.prefill is not None:  # stateless pools have
                        st.depth.setdefault(      # no prefill stage
                            "prefill", DepthHistogram()).record(q_pre)
                    st.depth.setdefault(
                        "handoff", DepthHistogram()).record(n_handoff)
                    st.depth.setdefault(
                        "decode", DepthHistogram()).record(q_dec)
            busy = False
            if phase in ("mixed", "prefill") and self.prefill is not None:
                busy |= self.prefill.tick()
            # always collect: handoffs/completions parked inside a member
            # engine are invisible to n_pending until moved up here
            self._collect_prefill()
            if phase in ("mixed", "handoff"):
                busy |= self._transfer_all_locked() > 0
            if phase in ("mixed", "decode"):
                # dead engines (submit raised) still tick: they receive no
                # new handoffs, but any resident work must drain — and a
                # genuinely dead engine's tick() raising is an explicit
                # failure, never a silent hang
                for eng in self.decodes:
                    busy |= eng.tick()
            self._collect_decode()
            return busy

    def run_until_idle(self) -> List[Any]:
        """Tick until every stage drains; returns the completions ready at
        exit (streaming events stay queued for ``poll(stream=True)``)."""
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
        for eng in self._members():
            eng.warmup()

    def stats(self) -> EngineStats:
        """Aggregated snapshot: member-engine work counters (preemptions
        included) summed, front-end completion/latency/depth/transfer
        histograms copied."""
        agg = EngineStats()
        for eng in self._members():
            s = eng.stats()
            agg.items += s.items
            agg.padded += s.padded
            agg.ticks += s.ticks
            agg.wall_s += s.wall_s
            agg.preempted += s.preempted
            for k, v in s.pages.items():
                agg.pages[k] = agg.pages.get(k, 0) + v
        with self._lock:
            agg.completed = self._stats.completed
            agg.latency = {k: h.copy()
                           for k, h in self._stats.latency.items()}
            agg.depth = {k: h.copy() for k, h in self._stats.depth.items()}
            agg.transfer = {k: h.copy()
                            for k, h in self._stats.transfer.items()}
            for k, v in self._stats.pages.items():
                agg.pages[k] = agg.pages.get(k, 0) + v
        return agg

    @property
    def n_pending(self) -> int:
        """Queued handoffs + pending work in every member engine."""
        n = sum(e.n_pending for e in self.decodes)
        if self.prefill is not None:
            n += self.prefill.n_pending
        with self._lock:
            return n + len(self._handoffs)

    @property
    def n_live_decodes(self) -> int:
        """Decode engines currently accepting new handoffs (excludes dead
        and draining engines) — the autoscaler's pool-size view."""
        return len([e for e in self.decodes
                    if e not in self._dead and e not in self._draining])

    @property
    def handoff_backlog(self) -> int:
        """Handoffs parked between prefill and decode right now."""
        with self._lock:
            return len(self._handoffs)

    # -- elastic decode pool -----------------------------------------------

    def add_decode(self, engine: EngineCore) -> None:
        """Join one decode engine to the pool (thread-safe; takes effect on
        the next handoff transfer).  The caller warms it up."""
        with self._tick_lock:
            self.decodes.append(engine)
            self.capacity += engine.capacity

    def retire_decode(self, engine: Optional[EngineCore] = None
                      ) -> Optional[EngineCore]:
        """Begin draining one decode engine: it receives no new handoffs,
        resident requests finish normally, and once idle
        ``reap_retired()`` removes it.  ``engine=None`` picks the newest
        live engine.  Returns the draining engine, or ``None`` when there
        is no candidate — the last live engine is never drained, so a
        scale-down can never strand traffic."""
        with self._tick_lock:
            live = [e for e in self.decodes
                    if e not in self._dead and e not in self._draining]
            if engine is None:
                if len(live) <= 1:
                    return None
                engine = live[-1]
            elif engine not in live or len(live) <= 1:
                return None
            self._draining.add(engine)
            return engine

    def reap_retired(self) -> List[EngineCore]:
        """Remove draining engines that finished their resident work.
        Their cumulative work counters stay in ``stats()``, so scale-downs
        never make the monotone stats run backwards."""
        with self._tick_lock:
            done = [e for e in self.decodes
                    if e in self._draining and e.n_pending == 0]
            for e in done:
                # drain parked results first: a completion left inside a
                # removed engine would be a silently dropped request
                for c in e.poll():
                    self._finish(c)
                evs = e.poll(stream=True)
                if evs:
                    with self._lock:
                        self._events.extend(evs)
                self._draining.discard(e)
                self.decodes.remove(e)
                self.capacity -= e.capacity
                self._retired.append(e)
            return done

    # -- internals ---------------------------------------------------------

    def _members(self) -> List[EngineCore]:
        return (([self.prefill] if self.prefill is not None else [])
                + self.decodes + self._retired)

    def _collect_prefill(self) -> None:
        if self.prefill is None:
            return
        for c in self.prefill.poll():
            if isinstance(c, CacheHandoff):
                c.t_handoff = self._clock()
                with self._lock:
                    self._handoffs.append(c)
            else:                     # identity completion (no decode leg)
                self._finish(c)

    def _collect_decode(self) -> None:
        for eng in self.decodes:
            for c in eng.poll():
                self._finish(c)
            evs = eng.poll(stream=True)
            if evs:
                with self._lock:
                    self._events.extend(evs)

    def _finish(self, completion: Any) -> None:
        now = self._clock()
        with self._lock:
            tr = self._inflight.pop(getattr(completion, "rid", None), None)
            if tr is not None:
                # end-to-end latency (both engine legs + the queue wait);
                # the decode engine stamped only its own leg.  The done
                # StreamEvent shares this object, so the stream sees the
                # same number.
                completion.latency_s = max(now - tr.t0, 0.0)
                self._stats.completed += 1
                self._stats.latency.setdefault(
                    tr.cls, LatencyHistogram()).record(completion.latency_s)
            self._completions.append(completion)

    def _transfer_all_locked(self) -> int:
        """Drain the handoff queue into the decode pool.  ``_locked`` = the
        caller holds ``_tick_lock`` (the engine-pool views read and written
        here — ``_dead``, ``_rr`` — are tick-owned); ``_lock`` is still
        taken internally for the handoff queue itself."""
        moved = 0
        while True:
            with self._lock:
                if not self._handoffs:
                    return moved
                h = self._handoffs.popleft()
            if self._transfer_one_locked(h):
                moved += 1
            else:
                with self._lock:       # requeued, never dropped
                    self._handoffs.appendleft(h)
                if not [e for e in self.decodes if e not in self._dead]:
                    raise RuntimeError(
                        f"all {len(self.decodes)} decode engines failed; "
                        f"{len(self._handoffs)} handoff(s) requeued and "
                        f"stranded")
                return moved

    def _transfer_one_locked(self, h: CacheHandoff) -> bool:
        # draining engines take no new work — unless every live engine is
        # draining (a mis-driven controller), in which case serving beats
        # stranding the handoff
        cands = [e for e in self.decodes
                 if e not in self._dead and e not in self._draining]
        if not cands:
            cands = [e for e in self.decodes if e not in self._dead]
        n = len(cands)
        for k in range(n):
            eng = cands[(self._rr + k) % n]
            pinned, full_rows = self._dedup_pages(h, eng)
            try:
                if h.stateless:
                    rec = None        # dispatch-only: no rows to move
                    eng.submit(h.request)
                else:
                    # deliver-then-submit: the transport moves the rows
                    # onto the target engine's device (a failed delivery
                    # leaves them untouched, so the next candidate
                    # re-delivers identical state)
                    rec = self.transport.deliver(h, eng)
                    eng.submit(HandoffRequest(handoff=h, rid=h.rid,
                                              stream=h.stream))
            except ValueError:
                # typed handoff rejection: a mis-built pair is a real bug
                # and must surface — but the never-dropped invariant still
                # holds, so the handoff goes back on the queue first
                self._undedup_pages(h, eng, pinned, full_rows)
                with self._lock:
                    self._handoffs.appendleft(h)
                raise
            # Engine (or its transport route) died mid-handoff: *any*
            # failure class here means the same thing — mark it dead and
            # fail over to the next candidate.  Nothing is swallowed: the
            # handoff is requeued by the caller (never-dropped invariant)
            # and a fully-dead pool raises RuntimeError there.
            # capslint: disable=exception-hygiene
            except Exception:
                self._undedup_pages(h, eng, pinned, full_rows)
                self._dead.add(eng)
                continue
            self._rr = (self._rr + k + 1) % max(n, 1)
            with self._lock:
                tr = self._stats.transfer
                tr.setdefault("handoff", LatencyHistogram()).record(
                    max(self._clock() - h.t_handoff, 0.0))
                if rec is not None:
                    for leg, s in rec.legs.items():
                        tr.setdefault(f"{rec.transport}/{leg}",
                                      LatencyHistogram()).record(s)
                    tr.setdefault(f"{rec.transport}/total",
                                  LatencyHistogram()).record(rec.total_s)
                if h.paged and not h.done:
                    pg = self._stats.pages
                    moved = len(h.page_missing
                                if h.page_missing is not None
                                else range(h.n_pages))
                    pg["handoff_pages_moved"] = (
                        pg.get("handoff_pages_moved", 0) + moved)
                    pg["handoff_pages_dedup"] = (
                        pg.get("handoff_pages_dedup", 0) + len(pinned))
            return True
        return False                  # caller requeues

    def _dedup_pages(self, h: CacheHandoff, eng: EngineCore
                     ) -> Tuple[Dict[int, int], Optional[Any]]:
        """Before delivering a paged handoff, pin the target pool's
        prefix-index hits for the advertised page hashes and strip those
        pages from the travelling payload — the handoff then moves only
        what the target doesn't already hold.  Returns the pins and the
        saved full payload for the failure unwind."""
        if (h.stateless or h.done or not h.paged or not h.page_hashes
                or not isinstance(h.rows, dict)):
            return {}, None
        pin = getattr(eng, "pin_page_hashes", None)
        if pin is None:
            return {}, None
        pinned = pin(h.page_hashes)
        if not pinned:
            return {}, None
        full_rows = h.rows
        missing = [i for i in range(h.n_pages) if i not in pinned]
        h.page_pinned = dict(pinned)
        h.page_missing = missing
        h.rows = {"pages": PagePool.take_payload(full_rows["pages"],
                                                 missing),
                  "residual": full_rows["residual"]}
        return pinned, full_rows

    def _undedup_pages(self, h: CacheHandoff, eng: EngineCore,
                       pinned: Dict[int, int], full_rows: Optional[Any]
                       ) -> None:
        """Failed delivery: restore the full payload and drop the pins
        taken on the failed target, so the next candidate (with its own
        prefix index) re-dedups from scratch."""
        if full_rows is not None:
            h.rows = full_rows
            h.ready = None
            h.page_missing = list(range(h.n_pages))
        h.page_pinned = None
        if pinned:
            eng.release_page_pins(list(pinned.values()))


def disaggregated_lm_engine(cfg, params, n_slots: int = 4,
                            max_len: int = 512, seed: int = 0,
                            n_decode: int = 1,
                            prefill_slots: Optional[int] = None,
                            prefill_scheduler: Optional[Scheduler] = None,
                            decode_schedulers: Optional[
                                List[Optional[Scheduler]]] = None,
                            scheduler: Optional[Scheduler] = None,
                            clock: Callable[[], float] = time.perf_counter,
                            kernel_tune: Optional[bool] = None,
                            transport: Optional[Any] = None,
                            page_size: Optional[int] = None,
                            n_pages: Optional[int] = None,
                            quantize_pages: bool = False,
                            decode_kernel: bool = False,
                            device: Any = None) -> DisaggregatedEngine:
    """The standard LM disaggregation: one :class:`PrefillEngine` feeding
    ``n_decode`` :class:`DecodeEngine`\\ s of ``n_slots`` slots each, built
    from the same ``params`` on ``device`` (``None`` means the card).
    Each engine keeps its own compute-type copy of the parameters.
    ``decode_schedulers`` gives one scheduler per decode engine (scheduler
    instances are stateful and must never be shared); ``scheduler`` is the
    front-end phase policy (:class:`repro_torch.serving.DisaggScheduler`
    by default); ``transport`` is the handoff delivery route (instance,
    name, or ``"auto"`` — see :class:`repro_torch.serving.Transport`)."""
    if decode_schedulers is None:
        decode_schedulers = [None] * n_decode
    if len(decode_schedulers) != n_decode:
        raise ValueError(f"need one decode scheduler per engine "
                         f"({len(decode_schedulers)} != {n_decode})")
    pk = dict(page_size=page_size, n_pages=n_pages,
              quantize_pages=quantize_pages, decode_kernel=decode_kernel,
              device=device)
    pre = PrefillEngine(cfg, params, n_slots=prefill_slots or n_slots,
                        max_len=max_len, seed=seed,
                        scheduler=prefill_scheduler, clock=clock,
                        kernel_tune=kernel_tune, **pk)
    dec = [DecodeEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                        seed=seed, scheduler=decode_schedulers[i],
                        clock=clock, kernel_tune=kernel_tune, **pk)
           for i in range(n_decode)]
    return DisaggregatedEngine(pre, dec, scheduler=scheduler, clock=clock,
                               transport=transport)


def multihost_disaggregated_lm_engine(cfg, params, n_slots: int = 4,
                                      max_len: int = 512, seed: int = 0,
                                      n_decode: int = 1,
                                      prefill_slots: Optional[int] = None,
                                      scheduler: Optional[Scheduler] = None,
                                      clock: Callable[[], float]
                                      = time.perf_counter,
                                      kernel_tune: Optional[bool] = None,
                                      transport: Optional[Any] = "auto",
                                      devices: Optional[List[Any]] = None,
                                      page_size: Optional[int] = None,
                                      n_pages: Optional[int] = None,
                                      quantize_pages: bool = False,
                                      decode_kernel: bool = False
                                      ) -> DisaggregatedEngine:
    """Multi-host-shaped LM disaggregation: the prefill engine and every
    decode engine own **distinct meshes** over disjoint device groups
    (:func:`repro_torch.parallel.sharding.disjoint_submeshes` over
    ``devices``, default every visible card), each under a
    :class:`repro_torch.serving.ShardedScheduler`, so a cache handoff
    crosses a device boundary and the transport does real work.  Each
    engine keeps its own compute copy of ``params`` on its devices and its
    slots there.  With fewer devices than engines the meshes reuse devices
    round-robin (on one card every engine is on it).

    ``transport`` defaults to ``"auto"``, which selects by placement:
    device-to-device when a decode engine's devices differ from the
    prefill engine's, in-process when they are the same (one card)."""
    from repro_torch.parallel.sharding import disjoint_submeshes

    meshes = disjoint_submeshes(1 + n_decode, devices=devices)
    pk = dict(page_size=page_size, n_pages=n_pages,
              quantize_pages=quantize_pages, decode_kernel=decode_kernel)
    pre = PrefillEngine(cfg, params, n_slots=prefill_slots or n_slots,
                        max_len=max_len, seed=seed,
                        scheduler=ShardedScheduler(meshes[0]), clock=clock,
                        kernel_tune=kernel_tune, **pk)
    dec = [DecodeEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                        seed=seed, scheduler=ShardedScheduler(meshes[1 + i]),
                        clock=clock, kernel_tune=kernel_tune, **pk)
           for i in range(n_decode)]
    return DisaggregatedEngine(pre, dec, scheduler=scheduler, clock=clock,
                               transport=transport)

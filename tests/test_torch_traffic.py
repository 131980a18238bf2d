"""Port parity for ``repro_torch.traffic`` (traces, replay, autoscaling,
admission) and priority preemption, on the CPU.

The reference's ``test_traffic.py`` contracts re-run against the port:

* determinism — identical seeds yield identical traces, requests and
  replay schedules/latencies (virtual clock end to end), and the port's
  traces, requests and toy replays equal the reference's event for event;
* autoscaling — on a bursty trace the autoscaled pool meets the static
  max-size pool's per-class p95 with fewer live engines on average, and
  scale-down (drain + reap) never drops a request;
* preemption — a preempted-then-resumed request produces exactly the
  sequence of an un-preempted run, on the toy engine and a tiny LM;
* admission — SLO backpressure rejects explicitly and accounts for every
  arrival.

The slice as a whole: a seeded bursty trace replayed on a virtual clock
against the disaggregated LM pool with autoscaling, priority schedulers
and SLO admission gives the reference's report (schedule, counts,
per-class latency, scale events) and tokens.  The reference's ragged-moe
case runs in ``test_torch_family_engine.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from engine_testlib import ToyEngine as RefToyEngine
from engine_testlib import ToyRequest as RefToyRequest
from repro import traffic as ref_traffic
from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import DecodeEngine as RefDecodeEngine
from repro.serving import PriorityScheduler as RefPriorityScheduler
from repro.serving import disaggregated_lm_engine as ref_disagg_engine
import repro_torch.traffic as port_traffic
from repro_torch import convert
from repro_torch.models.common import LMConfig
from repro_torch.serving import (DecodeEngine, DisaggregatedEngine,
                                 PriorityScheduler, Request, ServeEngine,
                                 disaggregated_lm_engine)
from repro_torch.traffic import (AutoscaleController, RequestClass,
                                 SLOAdmission, VirtualClock, build_lm_request,
                                 bursty_trace, poisson_trace, replay)
from torch_testlib import PortToyEngine, ToyRequest

torch.set_num_threads(1)

CLASSES = [RequestClass("short", weight=3.0, prompt_len=(2, 6),
                        max_new_tokens=(2, 4), priority=0,
                        slo_p95_ms=2000.0),
           RequestClass("long", weight=1.0, prompt_len=(8, 16),
                        max_new_tokens=(6, 10), priority=1)]


def ref_classes(classes=CLASSES):
    return [ref_traffic.RequestClass(**dataclasses.asdict(c))
            for c in classes]


def event_key(e):
    return (e.t, e.cls, e.seed)


class TestTraceDeterminism:
    def test_same_seed_same_trace(self):
        for gen in (lambda s: poisson_trace(CLASSES, 25.0, 2.0, seed=s),
                    lambda s: bursty_trace(CLASSES, [3.0, 80.0], [0.4, 0.2],
                                           2.0, seed=s)):
            a, b = gen(123), gen(123)
            assert [event_key(e) for e in a.events] \
                == [event_key(e) for e in b.events]
            assert len(a) > 0

    def test_different_seed_different_trace(self):
        a = poisson_trace(CLASSES, 25.0, 2.0, seed=1)
        b = poisson_trace(CLASSES, 25.0, 2.0, seed=2)
        assert [event_key(e) for e in a.events] \
            != [event_key(e) for e in b.events]

    def test_explicit_generator_accepted(self):
        a = poisson_trace(CLASSES, 25.0, 2.0, seed=7)
        b = poisson_trace(CLASSES, 25.0, 2.0,
                          seed=np.random.default_rng(7))
        assert [event_key(e) for e in a.events] \
            == [event_key(e) for e in b.events]

    def test_requests_deterministic_from_event_seed(self):
        tr = bursty_trace(CLASSES, [3.0, 80.0], [0.4, 0.2], 2.0, seed=5)
        for e in tr.events[:10]:
            c = tr.classes[e.cls]
            r1, r2 = build_lm_request(e, c), build_lm_request(e, c)
            assert isinstance(r1, Request)
            assert r1.prompt == r2.prompt
            assert r1.max_new_tokens == r2.max_new_tokens
            assert r1.priority == c.priority
            lo, hi = c.prompt_len
            assert lo <= len(r1.prompt) <= hi

    def test_events_sorted_and_within_horizon(self):
        tr = bursty_trace(CLASSES, [3.0, 80.0], [0.4, 0.2], 2.0, seed=5)
        ts = [e.t for e in tr.events]
        assert ts == sorted(ts)
        assert all(0.0 < t < tr.horizon for t in ts)
        assert set(tr.class_counts()) == {"short", "long"}

    @pytest.mark.parametrize("kind", ["poisson", "bursty", "bursty3"])
    def test_traces_and_requests_equal_the_reference(self, kind):
        def make(mod, classes):
            if kind == "poisson":
                return mod.poisson_trace(classes, 25.0, 2.0, seed=11)
            if kind == "bursty":
                return mod.bursty_trace(classes, [3.0, 80.0], [0.4, 0.2],
                                        2.0, seed=11)
            return mod.bursty_trace(classes, [0.0, 40.0, 90.0],
                                    [0.3, 0.2, 0.1], 2.0, seed=11)

        tr = make(port_traffic, CLASSES)
        ref = make(ref_traffic, ref_classes())
        assert [event_key(e) for e in tr.events] \
            == [event_key(e) for e in ref.events]
        assert tr.class_counts() == ref.class_counts()
        assert tr.rate() == ref.rate()
        for e, re in zip(tr.events, ref.events):
            r = build_lm_request(e, tr.classes[e.cls], vocab=64)
            rr = ref_traffic.build_lm_request(re, ref.classes[re.cls],
                                              vocab=64)
            assert (r.prompt, r.max_new_tokens, r.priority) \
                == (rr.prompt, rr.max_new_tokens, rr.priority)
        img_cls = RequestClass("img", kind="image", frames=(1, 3))
        img = ref_traffic.RequestClass("img", kind="image", frames=(1, 3))
        np.testing.assert_array_equal(
            port_traffic.build_image_request(tr.events[0], img_cls).images,
            ref_traffic.build_image_request(ref.events[0], img).images)

    def test_bad_arguments_rejected(self):
        with pytest.raises(ValueError):
            RequestClass("x", kind="audio")
        with pytest.raises(ValueError):
            poisson_trace(CLASSES, 0.0, 1.0)
        with pytest.raises(ValueError):
            bursty_trace(CLASSES, [1.0], [0.1], 1.0)
        with pytest.raises(ValueError):
            poisson_trace(CLASSES + CLASSES[:1], 1.0, 1.0)
        with pytest.raises(ValueError):
            build_lm_request(poisson_trace(CLASSES, 5.0, 2.0).events[0],
                             RequestClass("img", kind="image"))


def toy_factory(trace, steps=None, request_cls=ToyRequest):
    def make(ev):
        c = trace.classes[ev.cls]
        rng = np.random.default_rng(ev.seed)
        return request_cls(n_tasks=1,
                           steps=steps or int(rng.integers(1, 5)),
                           priority=c.priority)
    return make


class TestReplay:
    def test_replay_deterministic_and_lossless(self):
        tr = bursty_trace(CLASSES, [5.0, 80.0], [0.3, 0.2], 2.0, seed=3)

        def run():
            clk = VirtualClock()
            eng = PortToyEngine(capacity=4, clock=clk)
            return replay(eng, tr, factory=toy_factory(tr), clock=clk)

        r1, r2 = run(), run()
        assert r1.submitted == len(tr) and r1.dropped == 0
        assert r1.rejected == 0
        assert r1.schedule == r2.schedule
        assert r1.per_class == r2.per_class

    def test_replay_report_equals_the_reference(self):
        """The same trace replayed on a virtual clock against the toy
        engine of each package gives the same report."""
        tr = bursty_trace(CLASSES, [5.0, 80.0], [0.3, 0.2], 2.0, seed=3)
        ref_tr = ref_traffic.bursty_trace(ref_classes(), [5.0, 80.0],
                                          [0.3, 0.2], 2.0, seed=3)
        clk, ref_clk = VirtualClock(), ref_traffic.VirtualClock()
        rep = replay(PortToyEngine(capacity=2, clock=clk), tr,
                     factory=toy_factory(tr), clock=clk,
                     admission=SLOAdmission(max_backlog=6))
        ref = ref_traffic.replay(
            RefToyEngine(capacity=2, clock=ref_clk), ref_tr,
            factory=toy_factory(ref_tr, request_cls=RefToyRequest),
            clock=ref_clk, admission=ref_traffic.SLOAdmission(max_backlog=6))
        for f in ("submitted", "completed", "rejected", "dropped",
                  "horizon", "drain_s", "per_class", "schedule"):
            assert getattr(rep, f) == getattr(ref, f), f
        assert rep.stats.depth_summary() == ref.stats.depth_summary()

    def test_replay_idle_gap_jumps(self):
        """A sparse trace must replay in O(events) ticks, not O(horizon)."""
        tr = poisson_trace(CLASSES, 2.0, 10.0, seed=4)
        clk = VirtualClock()
        eng = PortToyEngine(capacity=2, clock=clk)
        rep = replay(eng, tr, factory=toy_factory(tr), clock=clk,
                     max_ticks=100 * max(len(tr), 1))
        assert rep.dropped == 0

    def test_admission_accounts_for_every_arrival(self):
        tr = bursty_trace(CLASSES, [5.0, 200.0], [0.2, 0.3], 1.5, seed=6)
        clk = VirtualClock()
        eng = PortToyEngine(capacity=1, clock=clk)
        adm = SLOAdmission(max_backlog=3, min_observations=4)
        rep = replay(eng, tr, factory=toy_factory(tr, steps=6), clock=clk,
                     admission=adm)
        assert rep.submitted + rep.rejected == len(tr)
        assert rep.rejected > 0              # the burst overran backlog 3
        assert rep.dropped == 0              # admitted work never dropped
        assert adm.admitted == rep.submitted
        assert adm.rejected == rep.rejected

    def test_no_slo_class_never_rejected(self):
        cls = [RequestClass("be", weight=1.0)]      # slo_p95_ms=None
        tr = poisson_trace(cls, 100.0, 0.5, seed=8)
        clk = VirtualClock()
        eng = PortToyEngine(capacity=1, clock=clk)
        rep = replay(eng, tr, factory=toy_factory(tr, steps=8), clock=clk,
                     admission=SLOAdmission(max_backlog=1))
        assert rep.rejected == 0 and rep.dropped == 0

    def test_virtual_clock_is_monotone(self):
        clk = VirtualClock(1.0)
        assert clk.advance_to(0.5) == 1.0
        with pytest.raises(ValueError):
            clk.advance(-0.1)


BURST = dict(rates=[5.0, 300.0], dwell=[0.4, 0.3], horizon=3.0, seed=42)


class TestAutoscale:
    def run_pool(self, autoscale, n_max=4, trace_kw=BURST, idle_steps=30):
        cls = [RequestClass("toy", weight=1.0)]
        tr = bursty_trace(cls, **trace_kw)
        clk = VirtualClock()

        def mk():
            return PortToyEngine(capacity=1, clock=clk)

        if autoscale:
            pool = DisaggregatedEngine(None, [mk()], clock=clk)
            ctrl = AutoscaleController(mk, min_engines=1, max_engines=n_max,
                                       grow_depth=2.0, hot_steps=5,
                                       idle_steps=idle_steps)
        else:
            pool = DisaggregatedEngine(None, [mk() for _ in range(n_max)],
                                       clock=clk)
            ctrl = None
        rep = replay(pool, tr, factory=toy_factory(tr, steps=25),
                     clock=clk, controller=ctrl)
        return rep, pool

    def test_autoscaled_matches_static_p95_with_fewer_engines(self):
        """The closed-loop acceptance criterion: same per-class p95 as a
        static max-size pool, strictly fewer engines on average."""
        auto, _ = self.run_pool(autoscale=True)
        static, _ = self.run_pool(autoscale=False)
        assert auto.dropped == 0 and static.dropped == 0
        assert auto.submitted == static.submitted > 0
        for cls_name, (n, _p50, p95) in static.per_class.items():
            an, _ap50, ap95 = auto.per_class[cls_name]
            assert an == n
            assert ap95 <= p95, (cls_name, ap95, p95)
        assert any(e.action == "grow" for e in auto.scale_events)
        assert auto.mean_live_engines is not None
        assert auto.mean_live_engines < 4.0

    def test_scale_down_drains_and_reaps_without_drops(self):
        """Burst then calm: the pool must shrink back (drain + reap) and
        still complete every admitted request."""
        rep, pool = self.run_pool(
            autoscale=True,
            trace_kw=dict(rates=[400.0, 4.0], dwell=[0.25, 3.0],
                          horizon=4.0, seed=9),
            idle_steps=10)
        actions = [e.action for e in rep.scale_events]
        assert "grow" in actions
        assert "drain" in actions and "reap" in actions
        assert rep.dropped == 0
        assert pool.n_live_decodes < 4
        # retired engines' work stays in the aggregated stats: every
        # request took exactly 25 toy steps, wherever it was served
        assert rep.stats.items == rep.completed * 25

    def test_retire_never_strands_last_engine(self):
        clk = VirtualClock()
        pool = DisaggregatedEngine(
            None, [PortToyEngine(capacity=1, clock=clk)], clock=clk)
        assert pool.retire_decode() is None
        assert pool.n_live_decodes == 1

    def test_controller_arguments_checked(self):
        with pytest.raises(ValueError):
            AutoscaleController(lambda: None, min_engines=0)
        with pytest.raises(ValueError):
            AutoscaleController(lambda: None, hot_steps=0)
        with pytest.raises(ValueError):
            AutoscaleController(lambda: None, grow_depth=0.0)


class TestToyPreemption:
    def test_priority_preempts_and_resumes_losslessly(self):
        eng = PortToyEngine(capacity=1, scheduler=PriorityScheduler())
        low = eng.submit(ToyRequest(steps=5, priority=5, stream=True))
        eng.tick()
        eng.tick()                       # low has run 2 of 5 steps
        high = eng.submit(ToyRequest(steps=2, priority=0))
        done = []
        while eng.n_pending:
            eng.tick()
            done += [c.rid for c in eng.poll()]
        assert done == [high, low]       # urgent work finished first
        assert eng.stats().preempted == 1
        steps = [ev.item[1] for ev in eng.poll(stream=True)
                 if ev.rid == low and not ev.done]
        assert steps == [4, 3, 2, 1, 0]

    def test_equal_priority_never_preempts(self):
        eng = PortToyEngine(capacity=1, scheduler=PriorityScheduler())
        eng.submit(ToyRequest(steps=4, priority=1))
        eng.tick()
        eng.submit(ToyRequest(steps=1, priority=1))
        eng.run_until_idle()
        assert eng.stats().preempted == 0

    def test_free_slots_absorb_urgent_work_without_eviction(self):
        eng = PortToyEngine(capacity=2, scheduler=PriorityScheduler())
        eng.submit(ToyRequest(steps=4, priority=5))
        eng.tick()
        eng.submit(ToyRequest(steps=1, priority=0))   # free slot available
        eng.run_until_idle()
        assert eng.stats().preempted == 0


TINY = dict(arch_id="tiny-preempt", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def model():
    """The tiny LM of both packages: reference params and their port
    copy, converted leaf by leaf."""
    ref_cfg = RefLMConfig(**TINY)
    ref_params = ref_lm.init(ref_cfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    return ref_cfg, ref_params, LMConfig(**TINY), params


class TestLMPreemption:
    """Lossless preemption on a real LM: cache rows evicted, re-injected at
    resume, token stream unchanged."""

    def test_preempted_tokens_equal_unpreempted_run(self, model):
        _, _, cfg, params = model
        long_req = dict(prompt=[1, 2, 3, 4, 5], max_new_tokens=10)
        short_req = dict(prompt=[7, 8], max_new_tokens=3)

        base = ServeEngine(cfg, params, n_slots=1, max_len=64, device="cpu")
        want = base.serve([Request(**long_req)])[0].tokens

        eng = ServeEngine(cfg, params, n_slots=1, max_len=64,
                          scheduler=PriorityScheduler(), device="cpu")
        low = eng.submit(Request(priority=5, **long_req))
        for _ in range(4):
            eng.tick()                   # partially decoded
        high = eng.submit(Request(priority=0, **short_req))
        comps = {c.rid: c for c in eng.run_until_idle()}
        assert eng.stats().preempted >= 1
        assert comps[low].tokens == want, "preemption lost decode state"
        assert len(comps[high].tokens) == 2 + 3

    def test_preemption_mid_queue_is_fifo_within_class(self, model):
        _, _, cfg, params = model
        eng = ServeEngine(cfg, params, n_slots=1, max_len=64,
                          scheduler=PriorityScheduler(), device="cpu")
        rids = [eng.submit(Request(prompt=[3, 4], max_new_tokens=2,
                                   priority=0)) for _ in range(3)]
        order = [c.rid for c in eng.run_until_idle()]
        assert order == rids


class TestPrioritySchedulerUnit:
    def test_select_picks_most_urgent_fifo_within_class(self):
        eng = PortToyEngine(capacity=1, scheduler=PriorityScheduler())
        sched = eng.scheduler

        class T:
            def __init__(self, p):
                self.priority = p

        q = [T(2), T(0), T(1), T(0)]
        assert sched.select(q) == 1          # first of the priority-0 pair

    def test_preempt_caps_evictions_per_tick(self):
        eng = PortToyEngine(capacity=4, scheduler=PriorityScheduler(
            max_evictions_per_tick=1))
        for _ in range(4):
            eng.submit(ToyRequest(steps=6, priority=9))
        eng.tick()                           # 4 low-priority residents
        for _ in range(4):
            eng.submit(ToyRequest(steps=1, priority=0))
        eng.tick()
        assert eng.stats().preempted == 1    # capped, not a mass eviction


@pytest.mark.parametrize("priority", [False, True])
def test_slice_replay_equals_reference(model, priority):
    """The slice as a whole: a seeded bursty trace on a virtual clock
    against the disaggregated LM pool (autoscaled from one decode engine
    up to two, SLO admission) — the port's report and tokens equal the
    reference's.  With a PriorityScheduler on each decode engine, urgent
    handoffs preempt resident ones: the tokens still equal the
    reference's, but the port resumes a preempted handoff from the rows
    its eviction saved where the reference decodes it again from the
    handoff, so latencies (and what the controller does with them) may
    differ."""
    ref_cfg, ref_params, cfg, params = model
    classes = [RequestClass("short", weight=3.0, prompt_len=(2, 6),
                            max_new_tokens=(2, 5), priority=0,
                            slo_p95_ms=50.0),
               RequestClass("long", weight=1.0, prompt_len=(8, 14),
                            max_new_tokens=(6, 9), priority=1)]
    kw = dict(rates=[10.0, 120.0], dwell=[0.05, 0.05], horizon=0.12,
              seed=3)
    tr = bursty_trace(classes, **kw)
    ref_tr = ref_traffic.bursty_trace(ref_classes(classes), **kw)
    assert len(tr) >= 6
    ctrl_kw = dict(min_engines=1, max_engines=2, grow_depth=1.0,
                   hot_steps=2, idle_steps=4)
    eng_kw = dict(n_slots=1, max_len=32)

    def sched(cls):
        return cls() if priority else None

    def run(port):
        clk = VirtualClock() if port else ref_traffic.VirtualClock()
        done = []
        if port:
            pool = disaggregated_lm_engine(
                cfg, params, clock=clk, device="cpu", decode_kernel=True,
                decode_schedulers=[sched(PriorityScheduler)], **eng_kw)

            def mk():
                return DecodeEngine(cfg, params, clock=clk, device="cpu",
                                    decode_kernel=True,
                                    scheduler=sched(PriorityScheduler),
                                    **eng_kw)
            mod, trace = port_traffic, tr
        else:
            pool = ref_disagg_engine(
                ref_cfg, ref_params, clock=clk,
                decode_schedulers=[sched(RefPriorityScheduler)], **eng_kw)

            def mk():
                return RefDecodeEngine(ref_cfg, ref_params, clock=clk,
                                       scheduler=sched(RefPriorityScheduler),
                                       **eng_kw)
            mod, trace = ref_traffic, ref_tr
        inner = pool.poll

        def poll(stream=False):       # keep the completions the replay
            out = inner(stream)       # drains, for the token comparison
            if not stream:
                done.extend(out)
            return out

        pool.poll = poll
        rep = mod.replay(pool, trace,
                         factory=mod.default_factory(trace, vocab=32),
                         clock=clk,
                         controller=mod.AutoscaleController(mk, **ctrl_kw),
                         admission=mod.SLOAdmission(min_observations=2))
        return rep, {c.rid: list(c.tokens) for c in done}

    rep, toks = run(port=True)
    ref, ref_toks = run(port=False)
    assert rep.dropped == 0 and rep.submitted > 0
    assert any(e.action == "grow" for e in rep.scale_events)
    assert len(toks) == rep.completed
    if priority:
        assert rep.stats.preempted > 0
        assert {r: t for r, t in toks.items() if r in ref_toks} \
            == {r: t for r, t in ref_toks.items() if r in toks}
        return
    for f in ("submitted", "completed", "rejected", "dropped", "horizon",
              "drain_s", "per_class", "schedule", "mean_live_engines"):
        assert getattr(rep, f) == getattr(ref, f), f
    assert [(e.t, e.action, e.n_live) for e in rep.scale_events] \
        == [(e.t, e.action, e.n_live) for e in ref.scale_events]
    assert toks == ref_toks
    assert rep.stats.items == ref.stats.items

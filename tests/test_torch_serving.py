"""Port parity for the serving layer: the slice as a whole (the same
parameters and the same ragged requests through both packages'
``FastCapsPipeline ... .serve()``), the scheduler contract of
``test_scheduler_conformance.py`` re-run against the port's schedulers on the
port's ``EngineCore``, and the engine's own surface."""

import threading

import numpy as np
import pytest
import torch

from repro.deploy import FastCapsPipeline as RefPipeline
from repro.serving import ImageRequest as RefImageRequest
from repro.serving import schedulers as ref_sched
from repro_torch.deploy import FastCapsPipeline
from repro_torch.serving import (CapsuleEngine, DepthHistogram, DisaggScheduler,
                                 EngineStats, FIFOScheduler, ImageCompletion,
                                 ImageRequest, InterleavingScheduler,
                                 LatencyHistogram, PriorityScheduler,
                                 Scheduler, SLOBatchScheduler, StreamEvent,
                                 TickRecord, pow2_bucket)
from repro_torch.serving import schedulers as port_sched
from repro_torch.serving.core import allocate_rid
from torch_testlib import (PortToyEngine, ToyRequest, images, paired_params,
                           small_cfgs)

torch.set_num_threads(1)

CAPACITY = 4
PHASES = {"mixed", "prefill", "decode", "handoff"}

SCHEDULERS = {
    "base": Scheduler,
    "fifo": FIFOScheduler,
    "slo": lambda: SLOBatchScheduler(target_p95_ms=5.0, window=4,
                                     min_samples=2),
    "interleave": lambda: InterleavingScheduler(decode_ratio=1),
    "disagg": DisaggScheduler,
    "disagg_overlap": lambda: DisaggScheduler(overlap=True),
    "priority": PriorityScheduler,
}


@pytest.fixture(params=sorted(SCHEDULERS))
def sched_name(request):
    return request.param


def make_engine(sched_name, capacity=CAPACITY):
    return PortToyEngine(capacity=capacity,
                         scheduler=SCHEDULERS[sched_name]())


def make_bound(sched_name, capacity=CAPACITY):
    return make_engine(sched_name, capacity).scheduler


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def _ragged_requests(cfg, seed=0, n_requests=5, max_frames=9):
    rng = np.random.RandomState(seed)
    return [images(100 + i, int(rng.randint(1, max_frames + 1)), cfg)
            for i in range(n_requests)]


@pytest.mark.parametrize("name,ref_name", [("cuda", "pallas"),
                                           ("optimized", "optimized"),
                                           ("reference", "reference")])
@pytest.mark.parametrize("sched", ["fifo", "slo"])
def test_slice_end_to_end_matches_reference(name, ref_name, sched):
    """Pruned and compacted CapsNet served through CapsuleEngine: equal
    classes, lengths within 1e-4 (float32 sums in another order)."""
    ref_cfg, port_cfg = small_cfgs()
    ref_params, port_params = paired_params(ref_cfg, seed=5)
    ref_dep = (RefPipeline(ref_cfg, params=ref_params)
               .prune(0.6, 0.9, type_keep=2).compact()
               .compile(routing=ref_name))
    dep = (FastCapsPipeline(port_cfg, params=port_params, device="cpu")
           .prune(0.6, 0.9, type_keep=2).compact().compile(routing=name))
    assert dep.cfg.n_primary_caps == ref_dep.cfg.n_primary_caps == 72

    def scheduler(mod):
        return (mod.SLOBatchScheduler(target_p95_ms=1e6) if sched == "slo"
                else mod.FIFOScheduler())

    ref_eng = ref_dep.serve(batch_size=4, scheduler=scheduler(ref_sched))
    eng = dep.serve(batch_size=4, scheduler=scheduler(port_sched))
    eng.warmup()
    frames = _ragged_requests(port_cfg)
    for i, x in enumerate(frames):
        ref_eng.submit(RefImageRequest(images=x, rid=i))
        eng.submit(ImageRequest(images=x, rid=i))
    ref_done = {c.rid: c for c in ref_eng.run_until_idle()}
    done = {c.rid: c for c in eng.run_until_idle()}
    assert sorted(done) == sorted(ref_done) == list(range(len(frames)))
    for i, x in enumerate(frames):
        assert isinstance(done[i], ImageCompletion)
        assert done[i].lengths.shape == (len(x), 10)
        assert done[i].classes.dtype == np.int32
        np.testing.assert_allclose(done[i].lengths, ref_done[i].lengths,
                                   atol=1e-4)
        np.testing.assert_array_equal(done[i].classes, ref_done[i].classes)
    st, ref_st = eng.stats(), ref_eng.stats()
    assert (st.frames, st.ticks, st.padded_frames, st.completed) == (
        ref_st.frames, ref_st.ticks, ref_st.padded_frames, ref_st.completed)


class TestCapsuleEngine:
    def _engine(self, **kw):
        ref_cfg, cfg = small_cfgs()
        _, params = paired_params(ref_cfg, 6)
        dep = FastCapsPipeline(cfg, params=params, device="cpu").compile(
            routing="cuda")
        return dep, dep.serve(**kw)

    def test_results_equal_direct_forward(self):
        dep, eng = self._engine(batch_size=4)
        x = images(1, 6, dep.cfg)
        (c,) = eng.serve([ImageRequest(images=x)])
        direct = dep.forward(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(c.lengths, direct, atol=1e-6)
        assert c.rid == 0 and c.latency_s >= 0.0

    def test_padding_and_stats(self):
        dep, eng = self._engine(batch_size=4)
        eng.serve([ImageRequest(images=images(2, 5, dep.cfg))])
        st = eng.stats()
        assert (st.frames, st.ticks, st.padded_frames) == (5, 2, 3)
        assert st.fps > 0 and st.ms_per_batch > 0
        assert list(st.latency_summary()) == ["image/f4"]
        assert st.depth_summary()["mixed"][0] == 2

    def test_bad_shapes_rejected_before_state_changes(self):
        dep, eng = self._engine(batch_size=4)
        with pytest.raises(ValueError, match="request images must be"):
            eng.submit(ImageRequest(images=np.zeros((2, 5, 5, 1), np.float32)))
        assert eng.n_pending == 0

    def test_zero_frame_request_completes_at_once(self):
        dep, eng = self._engine(batch_size=4)
        eng.submit(ImageRequest(images=np.zeros((0, 28, 28, 1), np.float32)))
        (c,) = eng.poll()
        assert c.classes.shape == (0,) and eng.stats().completed == 1

    def test_streaming_emits_one_event_per_frame(self):
        dep, eng = self._engine(batch_size=4)
        x = images(3, 3, dep.cfg)
        eng.submit(ImageRequest(images=x, stream=True))
        (c,) = eng.run_until_idle()
        events = eng.poll(stream=True)
        assert [e.seq for e in events] == [0, 1, 2, 3]
        assert all(isinstance(e, StreamEvent) for e in events)
        assert events[-1].done and events[-1].completion is c
        assert sorted(e.item[0] for e in events[:-1]) == [0, 1, 2]
        assert [e.item[1] for e in events[:-1]] == c.classes.tolist()

    def test_warmup_runs_every_scheduler_shape(self):
        dep, eng = self._engine(
            batch_size=8, scheduler=SLOBatchScheduler(target_p95_ms=50))
        seen = []
        orig = eng.forward_host
        eng.forward_host = lambda b: (seen.append(len(b)), orig(b))[1]
        eng.warmup()
        assert seen == [1, 2, 4, 8]
        assert eng.stats().ticks == 0          # warm-up is not served work

    def test_pretune_is_a_no_op_off_the_card(self, tmp_path, monkeypatch):
        from repro_torch.kernels import tuning
        monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))
        dep, eng = self._engine(batch_size=4, kernel_tune=True)
        eng.warmup()
        (c,) = eng.serve([ImageRequest(images=images(4, 2, dep.cfg))])
        assert len(c.classes) == 2
        assert not (tmp_path / "autotune.json").exists()

    def test_submit_from_another_thread(self):
        dep, eng = self._engine(batch_size=4)
        x = images(5, 3, dep.cfg)
        t = threading.Thread(
            target=lambda: eng.submit(ImageRequest(images=x, rid=7)))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        (c,) = eng.run_until_idle()
        assert c.rid == 7 and len(c.classes) == 3


# ---------------------------------------------------------------------------
# Scheduler contract (the reference's conformance suite on the port)
# ---------------------------------------------------------------------------


class TestBatchSelection:
    def test_capacity_never_exceeded(self, sched_name):
        eng = make_engine(sched_name)
        for i in range(6):
            eng.submit(ToyRequest(n_tasks=3, steps=2, rid=i))
        comps = eng.run_until_idle()
        assert eng.max_occupied <= eng.capacity
        assert eng.max_batch <= eng.capacity
        assert sorted(c.rid for c in comps) == list(range(6))

    def test_oldest_request_never_starved(self, sched_name):
        eng = make_engine(sched_name, capacity=2)
        first = eng.submit(ToyRequest(steps=3))
        done = []
        for _ in range(40):
            eng.submit(ToyRequest(steps=1))
            eng.tick()
            done += [c.rid for c in eng.poll()]
            if first in done:
                break
        assert first in done, f"{sched_name}: oldest request starved"

    def test_admission_is_fifo(self, sched_name):
        eng = make_engine(sched_name)
        rids = [eng.submit(ToyRequest(steps=2)) for _ in range(8)]
        eng.run_until_idle()
        assert eng.admitted_order == rids

    def test_results_identical_across_schedulers(self, sched_name):
        def outcome(name):
            eng = make_engine(name)
            comps = eng.serve([ToyRequest(n_tasks=n, steps=s, rid=i)
                               for i, (n, s) in enumerate(
                                   [(2, 1), (1, 3), (3, 2), (0, 1)])])
            return sorted((c.rid, c.items) for c in comps)

        assert outcome(sched_name) == outcome("fifo")


class TestPhaseLegality:
    def test_phase_vocabulary(self, sched_name):
        sched = make_bound(sched_name)
        for q in range(5):
            for a in range(5):
                assert sched.phase(q, a) in PHASES

    def test_unknown_phases_coerced_by_engine(self):
        eng = make_engine("disagg")
        comps = eng.serve([ToyRequest(steps=2) for _ in range(5)])
        assert len(comps) == 5


class TestPlacement:
    def test_place_preserves_values(self, sched_name):
        sched = make_bound(sched_name)
        x = np.arange(float(CAPACITY * 3), dtype=np.float32
                      ).reshape(CAPACITY, 3)
        np.testing.assert_array_equal(np.asarray(sched.place(x)), x)

    def test_place_idempotent_on_placed_arrays(self, sched_name):
        sched = make_bound(sched_name)
        x = torch.arange(float(CAPACITY * 2)).reshape(CAPACITY, 2)
        p1 = sched.place(x)
        p2 = sched.place(p1)
        assert torch.equal(p2, p1) and p2.device == x.device


class TestShapeCoherence:
    def test_quantize_bounds_and_shapes_cover(self, sched_name):
        sched = make_bound(sched_name, capacity=8)
        shapes = sched.shapes(8)
        assert all(1 <= b <= 8 for b in shapes)
        for n in range(1, 9):
            q = sched.quantize(n, 8)
            assert min(n, 8) <= q <= 8, (sched_name, n, q)
            assert q in shapes, (sched_name, n, q, shapes)

    def test_plan_positive(self, sched_name):
        sched = make_bound(sched_name)
        for q in range(5):
            for a in range(5):
                assert int(sched.plan(q, a)) >= 1


class TestSchedulersAgainstReference:
    @pytest.mark.parametrize("n,cap", [(0, 8), (1, 8), (3, 8), (8, 8),
                                       (9, 8), (5, 6), (100, 32)])
    def test_pow2_bucket(self, n, cap):
        assert pow2_bucket(n, cap) == ref_sched.pow2_bucket(n, cap)

    def test_sharded_scheduler_is_left_out(self):
        """No longer left out: the port's ShardedScheduler counts the
        mesh's batch-axis devices and rounds every tick shape up to a
        multiple of them as the reference's does (both read the mesh's
        ``axis_names`` and ``shape`` only, so one stand-in mesh serves)."""
        class Mesh:
            axis_names = ("pod", "data", "model")
            shape = {"pod": 2, "data": 2, "model": 4}
            devices = np.empty((2, 2, 4), dtype=object)

        class Core:
            capacity = 16

        Mesh.devices[...] = torch.device("cpu")
        ours = port_sched.ShardedScheduler(
            Mesh(), inner=SLOBatchScheduler(target_p95_ms=10.0))
        theirs = ref_sched.ShardedScheduler(
            Mesh(), inner=ref_sched.SLOBatchScheduler(target_p95_ms=10.0))
        ours.bind(Core()), theirs.bind(Core())
        assert ours.n_devices == theirs.n_devices == 4
        for n in range(17):
            assert ours.quantize(n, 16) == theirs.quantize(n, 16), n
        assert ours.shapes(16) == theirs.shapes(16)

    def test_slo_controller_tracks_the_reference(self):
        """The same tick latencies drive both controllers to the same
        effective batch at every step."""
        class Core:
            capacity = 16

        ours = SLOBatchScheduler(target_p95_ms=10.0, window=4, min_samples=2)
        theirs = ref_sched.SLOBatchScheduler(target_p95_ms=10.0, window=4,
                                             min_samples=2)
        ours.bind(Core()), theirs.bind(Core())
        rng = np.random.RandomState(0)
        walls = np.concatenate([rng.uniform(0.02, 0.03, 6),
                                rng.uniform(0.001, 0.002, 30),
                                rng.uniform(0.02, 0.03, 4)])
        for w in walls:
            ours.observe(TickRecord(4, 4, float(w)))
            theirs.observe(ref_sched.TickRecord(4, 4, float(w)))
            assert ours.effective_batch == theirs.effective_batch
            assert ours.plan(3, 1) == theirs.plan(3, 1)
        assert ours.shapes(16) == theirs.shapes(16) == (1, 2, 4, 8, 16)

    def test_slo_rejects_negative_target(self):
        with pytest.raises(ValueError):
            SLOBatchScheduler(target_p95_ms=-1)

    def test_interleaving_phases_track_the_reference(self):
        class Core:
            capacity = 4

        ours = InterleavingScheduler(decode_ratio=2)
        theirs = ref_sched.InterleavingScheduler(decode_ratio=2)
        ours.bind(Core()), theirs.bind(Core())
        states = [(3, 0), (2, 1), (2, 2), (2, 2), (1, 3), (0, 4), (1, 4),
                  (1, 2), (0, 0), (4, 0)]
        assert ([ours.phase(q, a) for q, a in states]
                == [theirs.phase(q, a) for q, a in states])
        with pytest.raises(ValueError):
            InterleavingScheduler(decode_ratio=-1)

    def test_priority_preempts_lowest_priority_resident(self):
        eng = PortToyEngine(capacity=1, scheduler=PriorityScheduler())
        low = eng.submit(ToyRequest(steps=3, priority=5))
        eng.tick()
        high = eng.submit(ToyRequest(steps=1, priority=0))
        eng.tick()
        assert [c.rid for c in eng.poll()] == [high]
        assert eng.stats().preempted == 1
        assert [c.rid for c in eng.run_until_idle()] == [low]
        with pytest.raises(ValueError):
            PriorityScheduler(max_evictions_per_tick=-1)


class TestEngineCore:
    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            PortToyEngine(capacity=0)

    def test_rid_rules(self):
        eng = PortToyEngine()
        assert eng.submit(ToyRequest()) == 0
        assert eng.submit(ToyRequest(rid=7)) == 7
        assert eng.submit(ToyRequest()) == 8
        with pytest.raises(ValueError, match="duplicate rid"):
            eng.submit(ToyRequest(rid=7))
        eng.run_until_idle()
        assert eng.submit(ToyRequest(rid=7)) == 7      # reusable once done

    def test_allocate_rid_function(self):
        r = ToyRequest()
        assert allocate_rid(r, {}, 3) == (3, 4) and r.rid == 3
        r = ToyRequest(rid=9)
        assert allocate_rid(r, {}, 3) == (9, 10)

    def test_bad_request_leaves_engine_untouched(self):
        eng = PortToyEngine()
        with pytest.raises(ValueError):
            eng.submit(ToyRequest(steps=0))
        assert eng.n_pending == 0 and eng.n_queued == 0
        assert eng.tick() is False

    def test_stats_snapshot_is_detached(self):
        eng = PortToyEngine()
        eng.serve([ToyRequest(n_tasks=2, steps=2)])
        snap = eng.stats()
        assert isinstance(snap, EngineStats)
        eng.serve([ToyRequest(n_tasks=1, steps=1)])
        assert snap.completed == 1 and eng.stats().completed == 2
        assert snap.latency["toy/t2"].count == 1
        assert snap.throughput > 0 and snap.batches == snap.ticks

    def test_injected_clock_drives_latency(self):
        now = [0.0]

        def clock():
            now[0] += 0.004
            return now[0]

        eng = PortToyEngine(clock=clock)
        (c,) = eng.serve([ToyRequest(steps=2)])
        assert c.latency_s > 0
        assert eng.stats().latency["toy/t1"].p50_ms >= 3.2

    def test_histograms(self):
        h = LatencyHistogram()
        assert h.p50_ms == 0.0 and h.mean_ms == 0.0
        for ms in (1, 1, 1, 100):
            h.record(ms / 1e3)
        assert h.p50_ms == pytest.approx(1.6) and h.p95_ms >= 100
        assert "n=4" in repr(h)
        d = DepthHistogram()
        for depth in (0, 3, 3, 9):
            d.record(depth)
        assert d.peak == 9 and d.p50 == 4 and d.mean == pytest.approx(3.75)
        c = d.copy()
        d.record(100)
        assert c.count == 4 and c.peak == 9

    def test_kernel_tune_scope_wraps_hooks(self):
        from repro_torch.kernels import tuning

        seen = []

        class Probe(PortToyEngine):
            def _step(self, active, n_batch):
                seen.append(tuning.tune_enabled())
                return super()._step(active, n_batch)

        for flag in (True, False):
            eng = Probe()
            eng.kernel_tune = flag
            eng.serve([ToyRequest()])
        assert seen == [True, False]

    def test_excluded_time_is_subtracted_from_tick_wall(self):
        class Slow(PortToyEngine):
            def _step(self, active, n_batch):
                self._exclude_tick_time(1e6)
                return super()._step(active, n_batch)

        eng = Slow()
        eng.serve([ToyRequest()])
        assert eng.stats().wall_s == 0.0

    def test_concurrent_submitters_lose_nothing(self):
        eng = PortToyEngine(capacity=3)
        n_threads, per_thread = 8, 25

        def worker():
            for _ in range(per_thread):
                eng.submit(ToyRequest(steps=1))

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        done = []
        while any(t.is_alive() for t in threads):
            eng.tick()
            done += eng.poll()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        done += eng.run_until_idle()
        assert len(done) == n_threads * per_thread
        assert len({c.rid for c in done}) == len(done)

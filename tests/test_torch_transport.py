"""The transport conformance suite (``test_transport_conformance.py``) run
against the port's transports (``repro_torch.serving.transport``), on the
CPU.

Every transport must deliver every rows leaf exactly (tree, shape, dtype,
values) onto the target's device, leave a row-less handoff alone, record
its declared legs on the injected clock, keep its records in delivery
order in a bounded ring, refuse to deliver once closed, and leave a
handoff untouched when its move fails.  The end-to-end section drives each
transport through the port's ``DisaggregatedEngine`` over the workload-free
toy pair (``torch_testlib.PortToyPrefillEngine`` ->
``PortToyDecodeEngine``), whose rows encode the handoff identity, so a
transport that corrupted a leaf would raise at decode admission.

The port has no meshes: where the reference targets a mesh, these tests
target an engine's ``device``.  On the card the device-to-device route is
a side-stream copy with an event, which ``chip_smoke.py``'s
``serve_disagg`` phase drives.
"""

import types

import pytest
import torch

from repro.serving import transport as ref_transport
from repro_torch.models.lm import cache_row_nbytes
from repro_torch.serving import (DeviceToDeviceTransport, DisaggregatedEngine,
                                 DisaggScheduler, HostStagedTransport,
                                 InProcessTransport, TransportError,
                                 make_transport, select_transport)
from repro_torch.serving.disagg import CacheHandoff
from torch_testlib import (PortToyDecodeEngine, PortToyPrefillEngine,
                           ToyCompletion, ToyRequest)

torch.set_num_threads(1)

TRANSPORTS = {
    "in_process": InProcessTransport,
    "host_staged": HostStagedTransport,
    "device_to_device": DeviceToDeviceTransport,
}
MOVING = ("host_staged", "device_to_device")


@pytest.fixture(params=sorted(TRANSPORTS))
def transport_name(request):
    return request.param


def make_rows(rid=0):
    """A rows tree with the variety a real cache handoff has: nested
    containers and float32, int32, bfloat16 and bool leaves."""
    return {
        "f32": torch.arange(12, dtype=torch.float32).reshape(3, 4) + rid,
        "i32": torch.tensor([[rid, 7], [3, 4]], dtype=torch.int32),
        "bf16": torch.tensor([0.5, 1.5, float(rid)], dtype=torch.bfloat16),
        "nested": {"flags": torch.tensor([True, False]),
                   "units": [torch.full((2, 2, 2), float(rid))]},
    }


def make_handoff(rid=0, rows="make", done=False):
    return CacheHandoff(
        rid=rid, request=ToyRequest(rid=rid, steps=2), family="toy",
        arch_id="toy", max_len=0,
        rows=None if rows is None else make_rows(rid),
        tok=0, pos=0, out=[], left=2, done=done)


def plain_target():
    return types.SimpleNamespace()


def device_target():
    return types.SimpleNamespace(device=torch.device("cpu"))


def flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flat(v, path + (i,))]
    return [(path, tree)]


def assert_rows_equal(got, want):
    got, want = flat(got), flat(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


class TestDeliveryExactness:
    @pytest.mark.parametrize("target_kind", ["plain", "device"])
    def test_every_leaf_exact(self, transport_name, target_kind):
        t = TRANSPORTS[transport_name]()
        target = plain_target() if target_kind == "plain" else device_target()
        h = make_handoff(rid=3)
        want = make_rows(rid=3)
        rec = t.deliver(h, target)
        assert_rows_equal(h.rows, want)
        assert rec.transport == transport_name
        assert rec.rid == 3
        assert rec.nbytes == cache_row_nbytes(want) > 0
        assert h.ready is None        # every move on the CPU has finished

    @pytest.mark.parametrize("device", ["cpu", "meta"])
    @pytest.mark.parametrize("name", MOVING)
    def test_device_placement(self, name, device):
        """Moving transports put every leaf on the target's device, as new
        tensors: the prefill engine's rows are never aliased."""
        t = TRANSPORTS[name]()
        h = make_handoff()
        before = flat(h.rows)
        t.deliver(h, types.SimpleNamespace(device=device))
        for (_, leaf), (_, old) in zip(flat(h.rows), before):
            assert leaf.device == torch.device(device)
            assert leaf.shape == old.shape and leaf.dtype == old.dtype
            if device == "cpu":
                assert leaf.data_ptr() != old.data_ptr()

    def test_in_process_is_passthrough(self):
        t = InProcessTransport()
        h = make_handoff()
        before = h.rows
        t.deliver(h, device_target())
        assert h.rows is before

    def test_done_handoff_moves_nothing(self, transport_name):
        t = TRANSPORTS[transport_name]()
        h = make_handoff(rows=None, done=True)
        rec = t.deliver(h, device_target())
        assert h.rows is None
        assert rec.legs == {}
        assert rec.nbytes == 0
        assert rec.total_s == 0.0

    def test_failed_move_leaves_the_handoff_untouched(self, transport_name):
        """All-or-nothing: a move that raises reassigns nothing, so the
        front-end can redeliver the same rows over another route."""
        t = TRANSPORTS[transport_name]()

        def boom(rows, target):
            raise TransportError("link down")

        t._move = boom
        h = make_handoff(rid=4)
        before, ready = h.rows, object()
        h.ready = None
        with pytest.raises(TransportError):
            t.deliver(h, device_target())
        assert h.rows is before and h.ready is None
        assert t.records == []
        h.ready = ready               # a pending event is kept as well
        with pytest.raises(TransportError):
            t.deliver(h, plain_target())
        assert h.ready is ready


class TestOrdering:
    def test_records_and_hook_in_delivery_order(self, transport_name):
        seen = []
        t = TRANSPORTS[transport_name](on_transfer=seen.append)
        for rid in range(5):
            t.deliver(make_handoff(rid=rid), plain_target())
        assert [r.rid for r in t.records] == list(range(5))
        assert [r.rid for r in seen] == list(range(5))
        assert seen == t.records

    def test_record_ring_is_bounded(self, transport_name):
        t = TRANSPORTS[transport_name](keep_records=3)
        for rid in range(7):
            t.deliver(make_handoff(rid=rid), plain_target())
        assert [r.rid for r in t.records] == [4, 5, 6]


class TestTiming:
    def test_declared_legs_recorded(self, transport_name):
        t = TRANSPORTS[transport_name]()
        rec = t.deliver(make_handoff(), device_target())
        assert tuple(rec.legs) == t.LEGS
        assert all(s >= 0.0 for s in rec.legs.values())
        assert rec.total_s == pytest.approx(sum(rec.legs.values()))

    def test_legs_measure_the_injected_clock(self, transport_name):
        # a clock that advances exactly 1 s per reading pins each leg to
        # 1.0 — the timing hook is the clock, not wall time
        ticks = iter(range(100))

        def clock():
            return float(next(ticks))

        t = TRANSPORTS[transport_name](clock=clock)
        rec = t.deliver(make_handoff(), device_target())
        assert rec.legs == {leg: 1.0 for leg in t.LEGS}
        assert rec.total_s == pytest.approx(float(len(t.LEGS)))

    def test_names_and_legs_equal_the_reference(self, transport_name):
        ref = ref_transport.TRANSPORTS[transport_name]
        port = TRANSPORTS[transport_name]
        assert port.name == ref.name == transport_name
        assert port.LEGS == ref.LEGS


class TestClose:
    def test_close_is_idempotent_and_fatal_to_deliver(self, transport_name):
        t = TRANSPORTS[transport_name]()
        t.deliver(make_handoff(), plain_target())
        t.close()
        t.close()                     # idempotent: second close is a no-op
        assert t.closed
        with pytest.raises(TransportError):
            t.deliver(make_handoff(rid=1), plain_target())
        assert [r.rid for r in t.records] == [0]   # failed delivery unrecorded

    def test_make_transport_names(self, transport_name):
        assert type(make_transport(transport_name)) \
            is TRANSPORTS[transport_name]
        with pytest.raises(ValueError):
            make_transport("carrier_pigeon")


class TestSelectTransport:
    """``auto`` reads the engines' devices: rows move device to device
    only when a decode engine sits on another device than prefill."""

    @pytest.mark.parametrize("decode_devices, want", [
        (["cpu", "cpu"], "in_process"),
        (["cpu", "meta"], "device_to_device"),
        ([None], "in_process"),
    ])
    def test_by_device(self, decode_devices, want):
        pre = types.SimpleNamespace(device=torch.device("cpu"))
        decs = [types.SimpleNamespace(device=d) for d in decode_devices]
        assert select_transport(pre, decs).name == want

    def test_stateless_pool_stays_in_process(self):
        decs = [types.SimpleNamespace(device=torch.device("meta"))]
        assert select_transport(None, decs).name == "in_process"
        assert DisaggregatedEngine(
            None, [PortToyDecodeEngine(capacity=1)],
            transport="auto").transport.name == "in_process"


class TestEndToEndToyDisagg:
    """Full front-end tick loop, no real prefill: the toy decode engine
    re-derives every expected rows leaf from the handoff identity and
    raises on any transit corruption, so completions arriving at all IS
    the exactness assertion."""

    def make_engine(self, transport_name, n_decode=2, scheduler=None):
        return DisaggregatedEngine(
            PortToyPrefillEngine(capacity=2),
            [PortToyDecodeEngine(capacity=2) for _ in range(n_decode)],
            scheduler=scheduler, transport=make_transport(transport_name))

    def test_served_exactly_with_per_leg_stats(self, transport_name):
        eng = self.make_engine(transport_name)
        for i in range(5):
            eng.submit(ToyRequest(steps=1 + i % 3, stream=bool(i % 2)))
        comps = eng.run_until_idle()
        assert sorted(c.rid for c in comps) == list(range(5))
        assert all(isinstance(c, ToyCompletion) for c in comps)
        st = eng.stats()
        assert st.completed == 5
        assert st.transfer["handoff"].count == 5
        assert st.transfer[f"{transport_name}/total"].count == 5
        for leg in eng.transport.LEGS:
            assert st.transfer[f"{transport_name}/{leg}"].count == 5

    def test_stream_events_ordered_across_boundary(self, transport_name):
        eng = self.make_engine(transport_name)
        rids = [eng.submit(ToyRequest(steps=3, stream=True))
                for _ in range(4)]
        eng.run_until_idle()
        seqs = {}
        for ev in eng.poll(stream=True):
            assert ev.seq == seqs.get(ev.rid, -1) + 1
            seqs[ev.rid] = ev.seq
        assert set(seqs) == set(rids)

    def test_overlap_scheduler_serves_exactly(self, transport_name):
        """DisaggScheduler(overlap=True) answers "mixed" while handoffs are
        queued, so transfers drain alongside decode ticks — the pairing
        for the asynchronous device-to-device transport; results must not
        change under any transport."""
        eng = self.make_engine(transport_name,
                               scheduler=DisaggScheduler(overlap=True))
        comps = eng.serve([ToyRequest(steps=2, rid=i) for i in range(4)])
        assert sorted(c.rid for c in comps) == list(range(4))
        assert eng.stats().transfer[f"{transport_name}/total"].count == 4

    def test_transport_records_one_per_handoff(self, transport_name):
        eng = self.make_engine(transport_name)
        for _ in range(3):
            eng.submit(ToyRequest(steps=2))
        eng.run_until_idle()
        recs = eng.transport.records
        assert len(recs) == 3
        assert all(r.nbytes > 0 for r in recs)

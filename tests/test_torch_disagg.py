"""Port parity for disaggregated serving (``repro_torch.serving.disagg``) on
the CPU, on the reference's disaggregation fixture: a tiny float32 dense
model, three ragged prompts, 2 slots a decode engine, ``max_len`` 32, 4 new
tokens, pages of 8 rows.

The port's ``DisaggregatedEngine`` (one ``PrefillEngine``, two
``DecodeEngine``\\ s, the kernels' wrappers on CPU tensors: flash prefill,
decode attention and fused sampling run their plain versions) must give,
under every transport and from dense, bf16-paged and int8-paged caches:

* the reference ``DisaggregatedEngine``'s greedy tokens and seeded draws
  exactly (integer-equal), on parameters converted leaf by leaf;
* the port's own ``generate()`` and unified ``ServeEngine`` tokens.

The rest re-runs the contracts of the reference's ``test_disagg.py`` and
``test_disagg_paged.py`` that apply to the dense family on one device:
streaming order across the boundary, the stats histograms, typed handoff
rejection that leaves the engine clean, failover with a killed engine or a
flaky transport (requeued, never dropped), page dedup, the stateless
CapsNet pool, and the launcher.  Each reference engine runs once per
module.  The vlm and moe families are served disaggregated in
``test_torch_family_engine.py``; ssm and hybrid wait for their models in
the port, the multi-host and 2-device cases for its sharding slice.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import Request as RefRequest
from repro.serving import disaggregated_lm_engine as ref_disagg_engine
from repro_torch import convert
from repro_torch.deploy import FastCapsPipeline
from repro_torch.launch import serve as port_serve
from repro_torch.models.common import LMConfig
from repro_torch.serving import (CacheHandoff, DecodeEngine,
                                 DisaggregatedEngine, DisaggScheduler,
                                 HandoffRequest, ImageRequest, PrefillEngine,
                                 PriorityScheduler, Request, ServeEngine,
                                 disaggregated_lm_engine)
from torch_testlib import PortFlakyTransport, small_cfgs

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
TRANSPORTS = ["in_process", "host_staged", "device_to_device"]
MAX_LEN = 32
MAX_NEW = 4
PAGE = 8
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")
MODES = {"dense": {}, "paged": dict(page_size=PAGE),
         "paged_int8": dict(page_size=PAGE, quantize_pages=True)}
# the port's engines take the kernels' wrappers (plain versions on the CPU)
KERNELS = dict(decode_kernel=True)

REF_CFG = RefLMConfig(**TINY)
CFG = dataclasses.replace(LMConfig(**TINY), attn_impl="cuda")
_REF = {}


def ref_params():
    if "params" not in _REF:
        _REF["params"] = ref_lm.init(REF_CFG, jax.random.key(0))
    return _REF["params"]


def port_params():
    return convert.params_from_numpy(jax.tree.map(np.asarray, ref_params()))


def _requests(request_cls, kind, prompts=PROMPTS, max_new=MAX_NEW):
    kw = SAMPLING_KW if kind == "seeded" else {}
    return [request_cls(prompt=list(p), max_new_tokens=max_new, rid=i,
                        **({"seed": 1000 + i} if kw else {}), **kw)
            for i, p in enumerate(prompts)]


def _tokens(comps):
    return {c.rid: list(c.tokens) for c in comps}


def ref_tokens(mode, kind):
    """The reference disaggregated engine's tokens, once per module."""
    key = (mode, kind)
    if key not in _REF:
        eng = ref_disagg_engine(REF_CFG, ref_params(), n_slots=2,
                                max_len=MAX_LEN, n_decode=2, **MODES[mode])
        _REF[key] = _tokens(eng.serve(_requests(RefRequest, kind)))
    return _REF[key]


def disagg(mode="dense", transport=None, n_decode=2, **kw):
    return disaggregated_lm_engine(
        CFG, port_params(), n_slots=2, max_len=MAX_LEN, n_decode=n_decode,
        transport=transport, device="cpu", **KERNELS, **MODES[mode], **kw)


def unified(max_len=MAX_LEN, **kw):
    return ServeEngine(CFG, port_params(), n_slots=2, max_len=max_len,
                       device="cpu", **kw)


def one_handoff(prompt=(1, 2, 3), max_new=MAX_NEW, **kw):
    pre = PrefillEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                        device="cpu", **kw)
    pre.submit(Request(prompt=list(prompt), max_new_tokens=max_new))
    (h,) = pre.run_until_idle()
    assert isinstance(h, CacheHandoff)
    return h


def decode_engine(max_len=MAX_LEN, cfg=CFG, **kw):
    return DecodeEngine(cfg, port_params(), n_slots=2, max_len=max_len,
                        device="cpu", **kw)


def generate_one(prompt, max_new=MAX_NEW):
    return unified().generate([list(prompt)], max_new_tokens=max_new)[0]


# ---------------------------------------------------------------------------
# Tokens: the reference's disaggregated engine, generate(), ServeEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_equal_reference_generate_and_unified(mode, transport):
    eng = disagg(mode, transport)
    got = _tokens(eng.serve(_requests(Request, "greedy")))
    assert got == ref_tokens(mode, "greedy")
    gen = unified()
    for i, p in enumerate(PROMPTS):
        assert gen.generate([p], max_new_tokens=MAX_NEW)[0] == got[i]
    assert got == _tokens(unified(**KERNELS, **MODES[mode]).serve(
        _requests(Request, "greedy")))
    st = eng.stats()
    assert st.completed == len(PROMPTS)
    assert st.transfer[f"{transport}/total"].count == len(PROMPTS)
    if mode != "dense":
        assert st.pages["handoff_pages_moved"] > 0


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_seeded_draws_equal_reference(mode, transport):
    """temperature > 0 draws cross the boundary with their seed: the
    decode side draws the reference's (and the unified engine's) exact
    counter-based sequence."""
    got = _tokens(disagg(mode, transport).serve(_requests(Request, "seeded")))
    assert got == ref_tokens(mode, "seeded")
    assert got == _tokens(unified(**KERNELS, **MODES[mode]).serve(
        _requests(Request, "seeded")))
    assert got != ref_tokens(mode, "greedy")      # the draws are not greedy


def test_chunked_decode_equals_kernel_decode():
    """Without the kernels' wrappers (host sampling, chunked attention)
    the disaggregated engine gives the same tokens."""
    eng = disaggregated_lm_engine(
        dataclasses.replace(CFG, attn_impl="chunked"), port_params(),
        n_slots=2, max_len=MAX_LEN, n_decode=2, device="cpu")
    assert (_tokens(eng.serve(_requests(Request, "greedy")))
            == ref_tokens("dense", "greedy"))


def test_zero_new_tokens_identity():
    eng = disagg()
    comps = eng.serve([Request(prompt=[4, 5, 6], max_new_tokens=0)])
    assert comps[0].tokens == [4, 5, 6]
    assert eng.stats().completed == 1


def test_single_token_finishes_at_prefill():
    """max_new_tokens=1 is fully served by the prefill side; the done
    handoff still routes through decode so stream/stat accounting is one
    path."""
    comps = disagg().serve([Request(prompt=[1, 2, 3], max_new_tokens=1)])
    assert comps[0].tokens == generate_one([1, 2, 3], 1)


# ---------------------------------------------------------------------------
# Streaming and stats
# ---------------------------------------------------------------------------


def test_token_order_across_handoff_boundary():
    eng = disagg()
    rids = [eng.submit(Request(prompt=p, max_new_tokens=3, stream=True))
            for p in PROMPTS]
    comps = {c.rid: c for c in eng.run_until_idle()}
    per_rid = {r: [] for r in rids}
    for ev in eng.poll(stream=True):
        per_rid[ev.rid].append(ev)
    for r, p in zip(rids, PROMPTS):
        evs = per_rid[r]
        assert [e.seq for e in evs] == list(range(len(evs)))
        assert evs[-1].done and evs[-1].item is None
        toks = [e.item for e in evs if not e.done]
        assert len(toks) == 3         # one event per generated token,
        #                               starting with the prefill-sampled one
        assert comps[r].tokens == list(p) + toks
        assert comps[r].tokens == generate_one(p, 3)
        # the done event carries the same (end-to-end) completion
        assert evs[-1].completion is comps[r]


def test_phase_depth_and_transfer_histograms():
    eng = disagg(n_decode=1)
    eng.serve([Request(prompt=p, max_new_tokens=3, rid=i)
               for i, p in enumerate(PROMPTS)])
    st = eng.stats()
    assert st.completed == 3
    assert st.items == 3 * 3          # generated tokens across both engines
    assert set(st.depth) >= {"prefill", "handoff", "decode"}
    assert st.depth["handoff"].peak >= 1
    assert st.transfer["handoff"].count == 3   # one transfer per request
    assert st.transfer["in_process/pass"].count == 3
    assert st.transfer["in_process/total"].count == 3
    assert st.latency_summary() and st.depth_summary() \
        and st.transfer_summary()


def test_snapshot_detached_and_monotone():
    eng = disagg(n_decode=1)
    eng.serve([Request(prompt=[1, 2], max_new_tokens=2)])
    s1 = eng.stats()
    eng.serve([Request(prompt=[3, 4], max_new_tokens=2)])
    s2 = eng.stats()
    assert s1.completed == 1 and s2.completed == 2
    assert s2.items > s1.items and s2.ticks > s1.ticks
    for k, h in s1.depth.items():
        assert s2.depth[k].count >= h.count
    assert s1.transfer["handoff"].count == 1   # detached snapshot


def test_handoff_rows_are_the_slot_state():
    """A dense handoff carries one slot's gathered rows (batch 1, bf16) of
    this many bytes, its pending token and position, and the request's
    sampling state."""
    h = one_handoff(max_new=4)
    k = h.rows["kv"]["k"]
    assert tuple(k.shape) == (CFG.n_layers, 1, MAX_LEN, CFG.n_kv_heads,
                              CFG.head_dim)
    assert k.dtype == torch.bfloat16
    assert (h.pos, h.left, len(h.out)) == (3, 3, 4)
    assert h.tok == h.out[-1] and h.seed != 0 and not h.done
    # the prompt's pow2 bucket (4 rows) is written, nothing past it
    assert float(k[:, 0, :3].abs().sum()) > 0.0
    assert float(k[:, 0, 4:].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Typed rejection
# ---------------------------------------------------------------------------


class TestHandoffValidation:
    """A decode engine must refuse a handoff it cannot decode exactly — no
    silent garbage decode."""

    def test_arch_mismatch_rejected(self):
        h = one_handoff()
        dec = decode_engine(cfg=dataclasses.replace(CFG, arch_id="other"))
        with pytest.raises(ValueError, match="family"):
            dec.submit(HandoffRequest(handoff=h))

    def test_max_len_mismatch_rejected(self):
        h = one_handoff()
        with pytest.raises(ValueError, match="max_len"):
            decode_engine(max_len=64).submit(HandoffRequest(handoff=h))

    def test_dtype_mismatch_rejected(self):
        h = one_handoff()
        h.rows = {"kv": {k: v.to(torch.float16)
                         for k, v in h.rows["kv"].items()}}
        with pytest.raises(ValueError, match="dtype"):
            decode_engine().submit(HandoffRequest(handoff=h))

    def test_shape_mismatch_rejected(self):
        h = one_handoff()
        h.rows = {"kv": {k: v[..., :-1] for k, v in h.rows["kv"].items()}}
        with pytest.raises(ValueError, match="shape"):
            decode_engine().submit(HandoffRequest(handoff=h))

    def test_tree_mismatch_rejected(self):
        h = one_handoff()
        h.rows = {"kv": {"k": h.rows["kv"]["k"]}}
        with pytest.raises(ValueError, match="tree structure"):
            decode_engine().submit(HandoffRequest(handoff=h))

    def test_rejection_leaves_engine_clean(self):
        """A refused handoff changes nothing: the engine still serves."""
        good = one_handoff()
        bad = one_handoff(prompt=(7, 8))
        bad.rows = {"kv": {k: v.to(torch.float16)
                           for k, v in bad.rows["kv"].items()}}
        dec = decode_engine()
        with pytest.raises(ValueError):
            dec.submit(HandoffRequest(handoff=bad))
        assert dec.n_pending == 0
        dec.submit(HandoffRequest(handoff=good, rid=good.rid))
        (comp,) = dec.run_until_idle()
        assert comp.tokens == generate_one([1, 2, 3])


# ---------------------------------------------------------------------------
# Failover and the never-dropped invariant
# ---------------------------------------------------------------------------


def _kill(engine):
    def boom(request):
        raise RuntimeError("decode engine killed mid-handoff")
    engine.submit = boom


class TestFailover:
    @pytest.mark.parametrize("transport", TRANSPORTS)
    def test_killed_engine_fails_over(self, transport):
        """An engine killed mid-handoff fails over under every transport —
        including the moving ones, whose delivery has already happened
        when the submit dies (the rows re-deliver to the survivor)."""
        eng = disagg(transport=transport)
        _kill(eng.decodes[0])
        rid = eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
        comps = eng.run_until_idle()
        assert [c.rid for c in comps] == [rid]      # requeued, not dropped
        assert eng._dead == {eng.decodes[0]}
        assert comps[0].tokens == generate_one([1, 2, 3])
        # both deliveries reached the transport's ring; the front-end's
        # stats count the one whose submit succeeded
        assert len(eng.transport.records) == 2
        assert eng.stats().transfer[f"{transport}/total"].count == 1

    def test_transport_error_mid_transfer_requeues_and_survives(self):
        """A route erroring mid-transfer behaves like a killed engine: the
        target is marked dead, the handoff requeues onto a surviving
        route, tokens stay exact, and the failed delivery leaves no
        partial state."""
        flaky = PortFlakyTransport(fail_on={0})     # first delivery dies
        eng = disagg(transport=flaky)
        rid = eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
        comps = eng.run_until_idle()
        assert [c.rid for c in comps] == [rid]
        assert len(eng._dead) == 1
        assert flaky.calls == 2                     # failed + surviving
        assert comps[0].tokens == generate_one([1, 2, 3])
        assert eng.stats().transfer["flaky/total"].count == 1

    def test_paged_failover_restores_the_payload(self):
        """A paged handoff deduped against a warm target that then dies is
        restored whole, its pins on the dead pool released, before the
        cold survivor takes every page."""
        shared = list(range(1, 17))
        eng = disaggregated_lm_engine(CFG, port_params(), n_slots=2,
                                      max_len=64, n_decode=2, device="cpu",
                                      page_size=PAGE, **KERNELS)
        prompts = [shared + [20], [30, 31], shared + [21]]
        comps = eng.serve([Request(prompt=prompts[0], max_new_tokens=4,
                                   rid=0)])            # lands on decodes[0]
        comps += eng.serve([Request(prompt=prompts[1], max_new_tokens=4,
                                    rid=1)])           # on decodes[1]
        warm = eng.decodes[0]         # holds the shared prefix's pages
        free = warm.free_pages
        _kill(warm)
        comps += eng.serve([Request(prompt=prompts[2], max_new_tokens=4,
                                    rid=2)])           # tries warm first
        assert eng._dead == {warm}
        assert warm.stats().pages["pinned"] == 2   # pinned, then released
        assert warm.free_pages == free
        ref = unified(max_len=64)
        for c in comps:
            assert c.tokens == ref.generate([prompts[c.rid]], 4)[0], c.rid
        pg = eng.stats().pages
        assert pg["handoff_pages_dedup"] == 0      # the survivor was cold
        assert pg["handoff_pages_moved"] == 3 + 1 + 3

    def test_no_decode_starvation_under_sustained_arrivals(self):
        eng = disaggregated_lm_engine(CFG, port_params(), n_slots=2,
                                      max_len=48, device="cpu", **KERNELS)
        first = eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=3))
        done = []
        for i in range(12):           # arrivals never pause
            eng.submit(Request(prompt=[4 + (i % 3)], max_new_tokens=3))
            eng.tick()
            done += [c.rid for c in eng.poll()]
            if first in done:
                break
        assert first in done, "resident decode starved by prefill arrivals"

    def test_typed_rejection_mid_transfer_requeues_before_raising(self):
        pre = PrefillEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                            device="cpu")
        bad = decode_engine(cfg=dataclasses.replace(CFG, arch_id="other"))
        eng = DisaggregatedEngine(pre, [bad])
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
        with pytest.raises(ValueError, match="family"):
            eng.run_until_idle()
        assert len(eng._handoffs) == 1              # requeued, not dropped

    def test_all_engines_dead_raises_with_handoff_requeued(self):
        pre = PrefillEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                            device="cpu")
        dec = decode_engine()
        _kill(dec)
        eng = DisaggregatedEngine(pre, [dec])
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
        with pytest.raises(RuntimeError, match="decode engines failed"):
            eng.run_until_idle()
        assert len(eng._handoffs) == 1              # stranded but not lost


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_preempted_handoff_resumes_from_its_own_rows(mode):
    """A PriorityScheduler on a decode engine preempts a resident handoff
    for an urgent one; the victim resumes from the rows its eviction saved
    (not from the handoff again), so its tokens are the undisturbed run's
    and its stream has each token once."""
    victim = dict(prompt=[1, 2, 3], max_new_tokens=8, rid=0, seed=42,
                  priority=1, stream=True, **SAMPLING_KW)
    want = unified(**KERNELS, **MODES[mode]).serve([Request(**victim)])[0]
    eng = disaggregated_lm_engine(
        CFG, port_params(), n_slots=1, max_len=MAX_LEN, n_decode=1,
        device="cpu", decode_schedulers=[PriorityScheduler()], **KERNELS,
        **MODES[mode])
    eng.submit(Request(**victim))
    for _ in range(4):
        eng.tick()
    eng.submit(Request(prompt=[9, 9], max_new_tokens=2, rid=1, seed=43,
                       priority=0, **SAMPLING_KW))
    comps = {c.rid: c for c in eng.run_until_idle()}
    assert eng.stats().preempted >= 1
    assert comps[0].tokens == want.tokens
    items = [e.item for e in eng.poll(stream=True)
             if e.rid == 0 and not e.done]
    assert items == want.tokens[3:]


# ---------------------------------------------------------------------------
# Paged handoffs
# ---------------------------------------------------------------------------


def test_shared_prefix_pages_do_not_travel_twice():
    """Two sequential requests share a 16-token (2-page) system prompt.
    The first handoff moves every page; by the second, the target pool
    caches the shared pages (registered on import), so the front-end pins
    them and ships only the tail — the reference's counters."""
    shared = list(range(1, 17))
    eng = disaggregated_lm_engine(CFG, port_params(), n_slots=2, max_len=64,
                                  n_decode=1, page_size=PAGE, device="cpu",
                                  **KERNELS)
    ref = unified(max_len=64)
    for i, t in enumerate([20, 21]):
        [c] = eng.serve([Request(prompt=shared + [t], max_new_tokens=4,
                                 rid=i)])
        assert c.tokens == ref.generate([shared + [t]], 4)[0], i
    st = eng.stats().pages
    assert st["handoff_pages_dedup"] == 2
    assert st["handoff_pages_moved"] == 4     # 3 pages, then the tail page


def _paged_handoff(prompt=(1, 2, 3), max_new=MAX_NEW, **pool_kw):
    h = one_handoff(prompt, max_new, page_size=PAGE, **pool_kw)
    assert h.paged and h.n_pages == 1 and h.page_missing == [0]
    return h


class TestPagedHandoffValidation:
    def test_paged_handoff_to_dense_engine_rejected(self):
        h = _paged_handoff()
        with pytest.raises(ValueError, match="paged"):
            decode_engine().submit(HandoffRequest(handoff=h))

    def test_dense_handoff_to_paged_engine_rejected(self):
        h = one_handoff()
        with pytest.raises(ValueError, match="paged"):
            decode_engine(page_size=PAGE).submit(HandoffRequest(handoff=h))

    def test_page_size_mismatch_rejected(self):
        h = _paged_handoff()
        with pytest.raises(ValueError, match="page_size"):
            decode_engine(page_size=16).submit(HandoffRequest(handoff=h))

    def test_quantization_mismatch_rejected(self):
        h = _paged_handoff()
        with pytest.raises(ValueError, match="quantized"):
            decode_engine(page_size=PAGE, quantize_pages=True).submit(
                HandoffRequest(handoff=h))

    def test_uncovered_pages_and_payload_leaves_rejected(self):
        h = _paged_handoff()
        h.page_missing = []
        with pytest.raises(ValueError, match="cover"):
            decode_engine(page_size=PAGE).submit(HandoffRequest(handoff=h))
        h = _paged_handoff()
        h.rows["pages"] = {k: v.to(torch.float16)
                           for k, v in h.rows["pages"].items()}
        with pytest.raises(ValueError, match="dtype"):
            decode_engine(page_size=PAGE).submit(HandoffRequest(handoff=h))

    def test_rejection_leaves_engine_clean(self):
        good = _paged_handoff()
        bad = _paged_handoff(prompt=(7, 8))
        bad.page_size = 16                # tamper: wrong geometry
        dec = decode_engine(page_size=PAGE)
        free = dec.free_pages
        with pytest.raises(ValueError):
            dec.submit(HandoffRequest(handoff=bad))
        assert dec.n_pending == 0 and dec.free_pages == free
        dec.submit(HandoffRequest(handoff=good, rid=good.rid))
        (comp,) = dec.run_until_idle()
        assert comp.tokens == generate_one([1, 2, 3])


# ---------------------------------------------------------------------------
# The stateless CapsNet pool and the launcher
# ---------------------------------------------------------------------------


def test_image_dispatch_pool():
    """prefill=None dispatches image requests over a pool of
    CapsuleEngines with the same front-end surface, validation at submit
    and transfer stats; classes and lengths equal one engine's (whose
    parity with the reference is ``test_torch_serving``'s)."""
    _, port_cfg = small_cfgs()
    dep = (FastCapsPipeline(port_cfg, device="cpu").build(seed=0)
           .prune(0.6, 0.9, type_keep=2).compact().compile(routing="cuda"))
    eng = DisaggregatedEngine(None, [dep.serve(batch_size=4)
                                     for _ in range(2)])
    rng = np.random.RandomState(0)
    frames = [rng.rand(n, 28, 28, 1).astype(np.float32) for n in (3, 2, 5)]
    done = {c.rid: c for c in eng.serve(
        [ImageRequest(x, rid=i) for i, x in enumerate(frames)])}
    single = {c.rid: c for c in dep.serve(batch_size=4).serve(
        [ImageRequest(x, rid=i) for i, x in enumerate(frames)])}
    for i in range(len(frames)):
        np.testing.assert_array_equal(done[i].classes, single[i].classes)
        np.testing.assert_array_equal(done[i].lengths, single[i].lengths)
    st = eng.stats()
    assert st.frames == 10 and st.completed == 3
    assert st.transfer["handoff"].count == 3
    assert "prefill" not in st.depth    # no prefill stage, no phantom row
    with pytest.raises(ValueError, match="images must be"):
        eng.submit(ImageRequest(np.zeros((2, 3, 3, 1), np.float32)))
    assert eng.n_pending == 0


def test_front_end_checks():
    with pytest.raises(ValueError, match="at least one"):
        DisaggregatedEngine(None, [])
    with pytest.raises(TypeError, match="Transport"):
        DisaggregatedEngine(None, [decode_engine()], transport=3)
    with pytest.raises(ValueError, match="one decode scheduler"):
        disagg(decode_schedulers=[None])
    eng = disagg(transport="auto", scheduler=DisaggScheduler(overlap=True))
    assert eng.transport.name == "in_process"   # one device: nothing moves


@pytest.mark.parametrize("extra", [
    ["--transport", "host_staged"],
    ["--transport", "device_to_device", "--paged", "--quantize-pages"],
])
def test_launcher_serves_disaggregated_on_the_cpu(capsys, extra):
    port_serve.main(["--arch", "llama3.2-1b", "--requests", "3",
                     "--max-new", "4", "--scheduler", "disagg",
                     "--decode-kernel", "--attn-impl", "cuda",
                     "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert "on cpu: served 3 requests (12 new tokens)" in out
    assert f"transfer[{extra[1]}/total]: n=3" in out


def test_launcher_capsnet_pool_and_refusals(capsys):
    port_serve.main(["--arch", "capsnet-mnist", "--requests", "3",
                     "--batch", "8", "--scheduler", "disagg",
                     "--device", "cpu"])
    assert "served 3 requests" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        port_serve.main(["--arch", "llama3.2-1b", "--scheduler", "disagg",
                         "--multihost"])
    assert e.value.code == 2
    assert "queue A item 5" in capsys.readouterr().err
    if not torch.cuda.is_available():
        for argv in (["--arch", "llama3.2-1b", "--scheduler", "disagg"],
                     ["--arch", "llama3.2-1b", "--trace", "bursty",
                      "--autoscale"],
                     ["--arch", "capsnet-mnist", "--scheduler", "disagg"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_serve.main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            disaggregated_lm_engine(CFG, port_params())

"""Port parity for paged LM serving (``ServeEngine(page_size=...)``) on the
CPU, on the reference's decode-kernel fixture: a tiny float32 dense model,
three ragged prompts, 2 slots, ``max_len`` 32, pages of 8 rows, 4 new
tokens; bfloat16 pages (``paged``) and int8 pages (``paged_int8``).

With ``decode_kernel=True`` (the decode and sampling kernels' plain
versions on the CPU, the pool read through the page tables) the port's
engine must give the reference kernel engine's greedy tokens and seeded
draws exactly, under fifo, priority and interleaved schedulers; so must its
own ``generate()`` and its gathered-view (chunked) paged engine.  The spill
and prefix-reuse fixtures of the reference's page tests give the
reference's tokens and counters.  Each reference engine runs once per
module.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import PriorityScheduler as RefPriorityScheduler
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch.models.common import LMConfig
from repro_torch.serving import (FIFOScheduler, InterleavingScheduler,
                                 PagePoolExhausted, PriorityScheduler,
                                 Request, ServeEngine)

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
PAGE = 8
MAX_LEN = 32
MAX_NEW = 4
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")
MODES = {"paged": dict(page_size=PAGE),
         "paged_int8": dict(page_size=PAGE, quantize_pages=True)}
SCHEDULERS = {"fifo": FIFOScheduler, "priority": PriorityScheduler,
              "interleave": lambda: InterleavingScheduler(decode_ratio=1)}

REF_CFG = RefLMConfig(**TINY)
CFG = LMConfig(**TINY)
_REF = {}


def ref_params():
    if "params" not in _REF:
        _REF["params"] = ref_lm.init(REF_CFG, jax.random.key(0))
    return _REF["params"]


def port_params():
    return convert.params_from_numpy(jax.tree.map(np.asarray, ref_params()))


def _serve(eng, request_cls, prompts=PROMPTS, max_new=MAX_NEW, **kw):
    comps = eng.serve([request_cls(prompt=list(p), max_new_tokens=max_new,
                                   rid=i, **({"seed": 1000 + i} if kw else {}),
                                   **kw)
                       for i, p in enumerate(prompts)])
    return {c.rid: list(c.tokens) for c in comps}


def ref_tokens(mode, kind):
    """The reference paged kernel engine's tokens (greedy or seeded)."""
    key = (mode, kind)
    if key not in _REF:
        eng = RefServeEngine(REF_CFG, ref_params(), n_slots=2,
                             max_len=MAX_LEN, decode_kernel=True,
                             **MODES[mode])
        kw = SAMPLING_KW if kind == "seeded" else {}
        _REF[key] = _serve(eng, RefRequest, **kw)
    return _REF[key]


def engine(mode, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    return ServeEngine(CFG, port_params(), device="cpu", **MODES[mode], **kw)


@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_equal_reference_kernel_engine(mode, sched):
    eng = engine(mode, decode_kernel=True, scheduler=SCHEDULERS[sched]())
    got = _serve(eng, Request)
    assert got == ref_tokens(mode, "greedy")
    gen = engine(mode)
    for i, p in enumerate(PROMPTS):
        assert gen.generate([p], max_new_tokens=MAX_NEW)[0] == got[i]
    assert _serve(engine(mode), Request) == got      # gathered-view path
    st = eng.stats().pages
    assert st["allocated"] > 0 and st["freed"] == st["allocated"]
    assert eng.free_pages == eng.total_pages


@pytest.mark.parametrize("decode_kernel", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_seeded_draws_equal_reference(mode, decode_kernel):
    got = _serve(engine(mode, decode_kernel=decode_kernel), Request,
                 **SAMPLING_KW)
    assert got == ref_tokens(mode, "seeded")
    assert got != ref_tokens(mode, "greedy")       # the draws are not greedy


@pytest.mark.parametrize("decode_kernel", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_preemption_does_not_change_draws(mode, decode_kernel):
    """The victim decodes alone, an urgent request takes the only slot, the
    victim resumes through its saved table row: its tokens are the
    undisturbed run's."""
    victim = dict(prompt=[1, 2, 3], max_new_tokens=8, rid=0, seed=42,
                  priority=1, **SAMPLING_KW)

    def mk():
        return engine(mode, n_slots=1, decode_kernel=decode_kernel,
                      scheduler=PriorityScheduler())

    [c] = mk().serve([Request(**victim)])
    eng = mk()
    eng.submit(Request(**victim))
    eng.tick()
    eng.tick()
    eng.submit(Request(prompt=[9, 9], max_new_tokens=2, rid=1, seed=43,
                       priority=0, **SAMPLING_KW))
    comps = {c.rid: list(c.tokens) for c in eng.run_until_idle()}
    assert eng.stats().preempted >= 1
    assert comps[0] == list(c.tokens)


def _spill_run(make_engine, request_cls):
    """The reference's spill fixture: 8 pages of 8 rows, one slot; the
    preempted request owns 6 pages and the urgent one needs 4, so the
    victim's pages must spill to the host before the urgent one prefills."""
    eng = make_engine()
    low_p, high_p = list(range(1, 41)), list(range(30, 54))
    low = eng.submit(request_cls(prompt=low_p, max_new_tokens=8, priority=5))
    eng.tick()
    eng.tick()
    high = eng.submit(request_cls(prompt=high_p, max_new_tokens=8,
                                  priority=0))
    done = {}
    while eng.n_pending:
        eng.tick()
        done.update({c.rid: c for c in eng.poll()})
    st = eng.stats()
    return ([done[low].tokens, done[high].tokens], st.preempted,
            st.pages.get("spilled_pages", 0))


@pytest.mark.parametrize("decode_kernel", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_spill_and_resume_match_reference(mode, decode_kernel):
    kw = dict(n_slots=1, max_len=64, n_pages=8, prefix_cache=False)
    key = ("spill", mode)
    if key not in _REF:
        _REF[key] = _spill_run(
            lambda: RefServeEngine(REF_CFG, ref_params(), **kw,
                                   **MODES[mode],
                                   scheduler=RefPriorityScheduler()),
            RefRequest)
    got = _spill_run(
        lambda: engine(mode, decode_kernel=decode_kernel,
                       scheduler=PriorityScheduler(), **kw), Request)
    assert got == _REF[key]
    assert got[1] == 1 and got[2] > 0                # spill really fired


SHARED = list(range(1, 17))                          # 2 full pages of 8


def _prefix_runs(make_engine, request_cls):
    """The reference's prefix fixtures: two requests sharing 16 tokens,
    one after the other and in the same tick, and with the cache off."""
    out = {}
    eng = make_engine(True)
    toks = [eng.serve([request_cls(prompt=SHARED + [t], max_new_tokens=4,
                                   rid=i)])[0].tokens
            for i, t in enumerate([20, 21])]
    out["sequential"] = (toks, eng.stats().pages)
    eng = make_engine(True)
    comps = eng.serve([request_cls(prompt=SHARED + [t], max_new_tokens=4,
                                   rid=i) for i, t in enumerate([20, 21])])
    out["same_tick"] = (sorted((c.rid, c.tokens) for c in comps),
                        eng.stats().pages)
    eng = make_engine(False)
    toks = [eng.serve([request_cls(prompt=SHARED + [t], max_new_tokens=4,
                                   rid=i)])[0].tokens
            for i, t in enumerate([20, 21])]
    out["off"] = (toks, eng.stats().pages)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_reuse_matches_reference(mode):
    key = ("prefix", mode)
    if key not in _REF:
        _REF[key] = _prefix_runs(
            lambda pc: RefServeEngine(REF_CFG, ref_params(), n_slots=2,
                                      max_len=64, prefix_cache=pc,
                                      decode_kernel=True, **MODES[mode]),
            RefRequest)
    got = _prefix_runs(
        lambda pc: engine(mode, max_len=64, prefix_cache=pc,
                          decode_kernel=True), Request)
    assert got == _REF[key]
    seq, same, off = (got[k][1] for k in ("sequential", "same_tick", "off"))
    full = 2 * (len(SHARED) + 1)
    for st in (seq, same):
        assert st["prefix_hits"] == 1 and st["prefix_pages_hit"] == 2
        assert st["prefill_tokens"] == full - len(SHARED)
    assert off["prefix_hits"] == 0 and off["prefill_tokens"] == full


def test_paged_engine_surface():
    eng = engine("paged")
    assert eng.paged and eng.total_pages == 2 * MAX_LEN // PAGE
    assert eng._caches is None and eng.cfg.decode_impl == "chunked"
    assert engine("paged", decode_kernel=True).cfg.decode_impl == "cuda"
    assert eng.pin_page_hashes([b"x" * 32]) == {}
    eng.release_page_pins([])
    dense = ServeEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                        device="cpu")
    assert not dense.paged and dense.free_pages is None
    assert dense.pin_page_hashes([None]) == {}
    with pytest.raises(ValueError, match="divide"):
        engine("paged", max_len=30)
    # a pool that cannot hold the resident demand raises, atomically
    small = engine("paged", n_slots=2, max_len=32, n_pages=4)
    small.submit(Request(prompt=list(range(1, 25)), max_new_tokens=2))
    small.submit(Request(prompt=list(range(1, 25)), max_new_tokens=2))
    with pytest.raises(PagePoolExhausted):
        small.run_until_idle()


def test_launcher_serves_paged_on_the_cpu(capsys):
    from repro_torch.launch import serve as port_serve

    port_serve.main(["--arch", "llama3.2-1b", "--requests", "3",
                     "--max-new", "4", "--device", "cpu", "--paged",
                     "--quantize-pages", "--decode-kernel", "--attn-impl",
                     "cuda"])
    out = capsys.readouterr().out
    assert "on cpu: served 3 requests (12 new tokens)" in out
    assert "pages: allocated=" in out


def test_reference_fixture_is_the_same_model():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)

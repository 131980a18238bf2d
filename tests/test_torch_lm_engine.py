"""Port parity for the LM serving engine (``repro_torch.serving.ServeEngine``)
on the CPU, on the reference's decode-kernel fixture: a tiny float32 dense
model, three ragged prompts, 2 slots, ``max_len`` 32, 4 new tokens.

The port's engine with ``decode_kernel=True`` (the decode and sampling
kernels' plain versions on the CPU) must give the reference's
``ServeEngine(decode_kernel=True)`` greedy tokens and its seeded
temperature > 0 draws exactly, under fifo, priority (with a lossless
preemption), interleaved and SLO-batching schedulers, and its own
``generate()`` must agree.  Each reference engine runs once per module.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.launch import serve as port_serve
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig
from repro_torch.serving import (FIFOScheduler, InterleavingScheduler,
                                 PagePool, PriorityScheduler, Request,
                                 ServeEngine, SLOBatchScheduler)

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
MAX_LEN = 32
MAX_NEW = 4
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")

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


def ref_tokens(kind):
    """The reference kernel engine's tokens (greedy or seeded), once."""
    if kind not in _REF:
        eng = RefServeEngine(REF_CFG, ref_params(), n_slots=2,
                             max_len=MAX_LEN, decode_kernel=True)
        kw = SAMPLING_KW if kind == "seeded" else {}
        _REF[kind] = _serve(eng, RefRequest, **kw)
    return _REF[kind]


def engine(**kw):
    kw.setdefault("n_slots", 2)
    return ServeEngine(CFG, port_params(), max_len=MAX_LEN, device="cpu",
                       **kw)


# "slo" admits one request at a time (its target is never missed, and the
# window never fills to double the batch), as chip_smoke.py's serve_lm
# starts its SLOBatchScheduler small
SCHEDULERS = {"fifo": FIFOScheduler, "priority": PriorityScheduler,
              "interleave": lambda: InterleavingScheduler(decode_ratio=1),
              "slo": lambda: SLOBatchScheduler(1000.0, initial_batch=1)}


@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
def test_greedy_tokens_equal_reference_kernel_engine(sched):
    got = _serve(engine(decode_kernel=True, scheduler=SCHEDULERS[sched]()),
                 Request)
    assert got == ref_tokens("greedy")
    gen = engine()
    for i, p in enumerate(PROMPTS):
        assert gen.generate([p], max_new_tokens=MAX_NEW)[0] == got[i]


def test_greedy_chunked_decode_equals_kernel_decode():
    assert (_serve(engine(), Request)
            == _serve(engine(decode_kernel=True), Request))


def test_batched_generate_equals_per_request():
    eng = engine()
    together = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    assert together == [eng.generate([p], max_new_tokens=MAX_NEW)[0]
                        for p in PROMPTS]


@pytest.mark.parametrize("decode_kernel", [True, False])
def test_seeded_draws_equal_reference(decode_kernel):
    got = _serve(engine(decode_kernel=decode_kernel), Request, **SAMPLING_KW)
    assert got == ref_tokens("seeded")
    assert got != ref_tokens("greedy")        # the draws are not greedy


@pytest.mark.parametrize("decode_kernel", [True, False])
def test_priority_preemption_is_lossless(decode_kernel):
    """The victim decodes alone, is evicted by an urgent request, resumes
    in another tick: its tokens are the undisturbed run's, and those are
    the reference's."""
    victim = dict(prompt=[1, 2, 3], max_new_tokens=8, rid=0, seed=42,
                  priority=1, **SAMPLING_KW)
    undisturbed = engine(n_slots=1, decode_kernel=decode_kernel,
                         scheduler=PriorityScheduler())
    [c] = undisturbed.serve([Request(**victim)])
    ref = RefServeEngine(REF_CFG, ref_params(), n_slots=1, max_len=MAX_LEN)
    [rc] = ref.serve([RefRequest(**victim)])
    assert list(c.tokens) == list(rc.tokens)

    eng = engine(n_slots=1, decode_kernel=decode_kernel,
                 scheduler=PriorityScheduler())
    eng.submit(Request(**victim))
    eng.tick()
    eng.tick()
    eng.submit(Request(prompt=[9, 9], max_new_tokens=2, rid=1, seed=43,
                       priority=0, **SAMPLING_KW))
    comps = {c.rid: list(c.tokens) for c in eng.run_until_idle()}
    assert eng.stats().preempted >= 1
    assert comps[0] == list(c.tokens)


def test_stream_events_carry_the_tokens():
    eng = engine(decode_kernel=True)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW, rid=i,
                           stream=True))
    eng.run_until_idle()
    events = eng.poll(stream=True)
    for rid, tokens in ref_tokens("greedy").items():
        mine = [e for e in events if e.rid == rid]
        assert [e.item for e in mine[:-1]] == tokens[len(PROMPTS[rid]):]
        assert mine[-1].done and mine[-1].completion.tokens == tokens
    st = eng.stats()
    assert st.completed == 3 and st.items == 3 * MAX_NEW


def test_slot_finishes_at_max_len_and_rids_are_assigned():
    eng = engine(decode_kernel=True)
    long = list(range(1, MAX_LEN - 1))
    rid = eng.submit(Request(prompt=long, max_new_tokens=10))
    [c] = eng.run_until_idle()
    assert c.rid == rid and len(c.tokens) == MAX_LEN + 1


def test_engine_checks():
    with pytest.raises(ValueError, match="empty prompt"):
        engine().submit(Request(prompt=[]))
    with pytest.raises(ValueError, match="no room"):
        engine().submit(Request(prompt=[1] * MAX_LEN))
    # paged caches are served (test_torch_paged_engine); a page length
    # that does not divide max_len is refused
    assert ServeEngine(CFG, port_params(), page_size=8, device="cpu").paged
    with pytest.raises(ValueError, match="divide"):
        ServeEngine(CFG, port_params(), page_size=5, device="cpu")
    # an encoder has no decode path; a recurrent family's state has no
    # sequence axis to page (both as in the reference)
    with pytest.raises(ValueError, match="encoder models have no decode"):
        ServeEngine(dataclasses.replace(CFG, family="audio"), port_params(),
                    device="cpu")
    ssm = port_configs.reduced(port_configs.get_config("xlstm-1.3b"))
    with pytest.raises(ValueError, match="recurrent"):
        PagePool(ssm, 2, MAX_LEN, 8)
    [c] = engine().serve([Request(prompt=[1, 2], max_new_tokens=0)])
    assert c.tokens == [1, 2]


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(CFG, port_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_lm.init(CFG, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_lm.make_caches(CFG, 1, 4)


def test_decode_kernel_sets_the_decode_impl():
    assert engine(decode_kernel=True).cfg.decode_impl == "cuda"
    assert engine().cfg.decode_impl == "chunked"


@pytest.mark.parametrize("extra", [[], ["--decode-kernel", "--attn-impl",
                                        "cuda", "--scheduler", "interleave"]])
def test_launcher_serves_an_lm_on_the_cpu(capsys, extra):
    port_serve.main(["--arch", "llama3.2-1b", "--requests", "3",
                     "--max-new", "4", "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert "on cpu: served 3 requests (12 new tokens)" in out


@pytest.mark.parametrize("arch,extra", [
    ("deepseek-moe-16b", ["--decode-kernel", "--attn-impl", "cuda"]),
    ("dbrx-132b", ["--paged", "--quantize-pages", "--decode-kernel"]),
    ("llama-3.2-vision-90b", ["--decode-kernel", "--attn-impl", "cuda"]),
    ("llama-3.2-vision-90b", ["--paged", "--scheduler", "disagg",
                              "--transport", "host_staged"])])
def test_launcher_serves_moe_and_vlm_on_the_cpu(capsys, arch, extra):
    port_serve.main(["--arch", arch, "--requests", "3", "--max-new", "4",
                     "--device", "cpu"] + extra)
    assert f"[{arch}] on cpu: served 3 requests (12 new tokens)" in \
        capsys.readouterr().out


def test_launcher_refuses_parameters_the_card_cannot_hold():
    """A float32 deepseek-moe-16b holds 67.5 GB of parameters and the
    engine's 33.8 GB bf16 copy: past an 80 GB card's free memory, refused
    before a weight is drawn, with both numbers named."""
    from repro_torch import configs as port_configs

    cfg = port_configs.get_config("deepseek-moe-16b")
    need = port_serve.param_bytes_served(cfg)
    assert 100e9 < need < 102e9
    free = 79_000_000_000
    with pytest.raises(SystemExit, match=f"{need:,} bytes.*{free:,} bytes"):
        port_serve.check_fits(cfg, free)
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    assert port_serve.param_bytes_served(bf16) == need // 3
    port_serve.check_fits(bf16, free)           # 33.8 GB fits


def test_lm_engine_warmup_is_a_no_op_in_both_packages():
    """The reference's launcher calls ``engine.warmup()`` on an LM engine
    under ``--kernel-tune`` (``repro/launch/serve.py``); the port's LM
    launcher does not.  In both packages an LM engine's ``warmup`` runs only
    the ``_pretune`` and ``_warmup`` hooks of ``EngineCore``, which
    ``ServeEngine`` and its disaggregated members leave empty (the kernels
    are tuned at their first call instead: ``_maybe_tune_prefill``, the
    registry's ``resolve_config``), so the reference's call changes
    nothing and its absence is no fault.  The CapsNet engine has hooks of
    its own, and the port's launcher warms it."""
    import inspect

    from repro.serving import core as ref_core
    from repro.serving import disagg as ref_disagg
    from repro_torch.serving import core as port_core
    from repro_torch.serving import disagg as port_disagg
    from repro_torch.serving import engine as port_engine

    for core, classes in (
            (ref_core, (RefServeEngine, ref_disagg.PrefillEngine,
                        ref_disagg.DecodeEngine)),
            (port_core, (port_engine.ServeEngine, port_disagg.PrefillEngine,
                         port_disagg.DecodeEngine))):
        for cls in classes:
            for hook in ("_pretune", "_warmup", "warmup"):
                assert getattr(cls, hook) is getattr(core.EngineCore, hook), \
                    (cls.__module__, cls.__name__, hook)
        for hook in ("_pretune", "_warmup"):
            body = inspect.getsource(getattr(core.EngineCore, hook))
            assert body.rstrip().endswith("pass")
    src = inspect.getsource(port_serve)
    assert "engine.warmup()" in src          # the CapsNet branch

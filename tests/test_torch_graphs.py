"""The port's compiled entry points (``repro_torch.graphs``) on the CPU.

On the card the CapsNet forward and every family's kernel decode tick
are captured CUDA graphs, the port's counterparts of the reference's
``jax.jit`` executables; on the CPU the same call sites run the same
staged code eagerly.  Held here:

* the staged decode tick hands the model and the sampling kernel, bit for
  bit, what the unstaged tick passed: tokens, positions, page tables with
  their ``-1`` sentinels, and the five sampling rows (a seed of 2^31 or
  more, a top-p of 1.0 among them);
* its greedy and seeded tokens, dense and paged, bf16 and int8 pages, are
  the reference ``ServeEngine``'s on converted parameters;
* ``CapsuleEngine``'s classes through the staged forward are the reference
  ``DeployedCapsNet``'s, and two forward results never alias;
* :class:`repro_torch.graphs.CapturedCall`'s bookkeeping, with the CUDA
  calls stubbed: a capture records the launch counts it saw and sets the
  counters back, each replay adds them once, a moved tensor re-captures
  (counted), a tuner run or a kernel build inside a capture raises;
* ``graph-purity`` reports a ``.item()`` planted in a copy of each captured
  body, and nothing in the real ones;
* ROADMAP §C Open 2: a tuned decode config is keyed without the batch, so
  a slot's launch plan is the same at every batch.
"""

import dataclasses
import importlib
import inspect
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.deploy import FastCapsPipeline as RefPipeline
from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import ImageRequest as RefImageRequest
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert, graphs
from repro_torch.analysis import Project, apply_suppressions
from repro_torch.analysis.checkers.purity import GraphPurityChecker, Root
from repro_torch.deploy import FastCapsPipeline
from repro_torch.deploy import pipeline as port_pipeline
from repro_torch.kernels import build, tuning
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.sampling import kernel as sampling_kernel
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig
from repro_torch.serving import ImageRequest, Request, ServeEngine
from repro_torch.serving import engine as port_engine
from torch_testlib import images, paired_params, small_cfgs

torch.set_num_threads(1)

# the module (the package re-exports the registry object under its name)
kernel_registry = importlib.import_module("repro_torch.kernels.registry")

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
PAGE = 8
MAX_LEN = 32
MAX_NEW = 4
TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")
MODES = {"dense": {}, "paged": dict(page_size=PAGE),
         "paged_int8": dict(page_size=PAGE, quantize_pages=True)}
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
REF_CFG = RefLMConfig(**TINY)
CFG = LMConfig(**TINY)
_REF = {}


def ref_params():
    if "params" not in _REF:
        _REF["params"] = ref_lm.init(REF_CFG, jax.random.key(0))
    return _REF["params"]


def port_params():
    return convert.params_from_numpy(jax.tree.map(np.asarray, ref_params()))


def requests(request_cls, kind):
    """The three prompts, greedy or seeded (seed 1000 + index)."""
    kw = SAMPLING_KW if kind == "seeded" else {}
    return [request_cls(prompt=list(p), max_new_tokens=MAX_NEW, rid=i,
                        **({"seed": 1000 + i} if kw else {}), **kw)
            for i, p in enumerate(PROMPTS)]


def tokens(eng, reqs):
    return {c.rid: list(c.tokens) for c in eng.serve(reqs)}


class Unstaged(ServeEngine):
    """The engine with its decode tick unstaged (the eager tick as it was
    before the staging): what the staged tick is held against."""

    _staged = False


# ---------------------------------------------------------------------------
# The staged decode tick
# ---------------------------------------------------------------------------


def mixed_requests():
    """Greedy and sampled requests; the sampled ones' seeds at and past
    2^31 and their top-p 1.0 or less, so every row's bits are exercised."""
    kws = [dict(),
           dict(temperature=0.8, top_k=8, top_p=1.0, seed=2 ** 31 + 5),
           dict(temperature=1.3, top_k=0, top_p=0.9, seed=2 ** 32 - 3)]
    return [Request(prompt=list(p), max_new_tokens=MAX_NEW + 2, rid=i, **kw)
            for i, (p, kw) in enumerate(zip(PROMPTS, kws))]


def record_ticks(monkeypatch, log):
    """Log, for every decode step and sampling launch, the tokens,
    positions and tables the model gets and the five rows the sampling
    kernel's wrapper gets (as int32 bit patterns)."""
    decode_step = port_lm.decode_step
    sample = sampling_kernel.fused_sampling_cuda

    def step(params, cfg, batch, caches, paged_tables=None):
        log.append(("decode", batch["tokens"].clone(), batch["pos"].clone(),
                    None if paged_tables is None
                    else paged_tables.to(torch.int64).clone()))
        return decode_step(params, cfg, batch, caches,
                           paged_tables=paged_tables)

    def sampling(logits, temperature, seeds, pos, top_k, top_p, **kw):
        log.append(("sample", torch.stack([
            temperature.view(torch.int32), seeds, pos, top_k,
            top_p.view(torch.int32)]).clone()))
        return sample(logits, temperature, seeds, pos, top_k, top_p, **kw)

    monkeypatch.setattr(port_lm, "decode_step", step)
    monkeypatch.setattr(sampling_kernel, "fused_sampling_cuda", sampling)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_staged_buffers_hold_what_the_unstaged_tick_passed(mode,
                                                           monkeypatch):
    params = port_params()
    logs = {}
    for name, cls in (("staged", ServeEngine), ("unstaged", Unstaged)):
        log = logs[name] = []
        record_ticks(monkeypatch, log)
        eng = cls(CFG, params, n_slots=2, max_len=MAX_LEN, device="cpu",
                  decode_kernel=True, **MODES[mode])
        reqs = mixed_requests()
        got = tokens(eng, reqs)
        monkeypatch.undo()
        logs[name + "_tokens"] = got
    staged, unstaged = logs["staged"], logs["unstaged"]
    assert logs["staged_tokens"] == logs["unstaged_tokens"]
    assert [e[0] for e in staged] == [e[0] for e in unstaged]
    assert sum(e[0] == "decode" for e in staged) >= MAX_NEW
    for a, b in zip(staged, unstaged):
        if a[0] == "decode":
            assert a[1].dtype == b[1].dtype == torch.int32
            assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            assert (a[3] is None) == (b[3] is None) == (mode == "dense")
            if a[3] is not None:
                assert torch.equal(a[3], b[3])
        else:
            assert torch.equal(a[1], b[1])
    # the sampling rows against the requests, independently of the engine
    sentinels = [e[3] for e in staged if e[0] == "decode" and e[3] is not None]
    if mode != "dense":
        assert any((t < 0).any() for t in sentinels)   # unmapped pages: -1
    rows = [e[1] for e in staged if e[0] == "sample"]
    reqs = {r.rid: r for r in mixed_requests()}
    seen = set()
    for row in rows:
        for slot in range(row.shape[1]):
            temp, seed, _, top_k, top_p = (int(x) for x in row[:, slot])
            if temp == 0:
                continue                  # greedy, or a free slot
            r = next(r for r in reqs.values() if np.float32(
                r.temperature).view(np.int32) == temp)
            assert seed == np.uint32(r.seed).view(np.int32)
            assert top_k == r.top_k
            assert top_p == np.float32(r.top_p).view(np.int32)
            seen.add(r.rid)
    assert seen == {1, 2}                 # seeds >= 2^31 kept their bits


def ref_tokens(mode, kind):
    key = (mode, kind)
    if key not in _REF:
        eng = RefServeEngine(REF_CFG, ref_params(), n_slots=2,
                             max_len=MAX_LEN, decode_kernel=True,
                             **MODES[mode])
        _REF[key] = tokens(eng, requests(RefRequest, kind))
    return _REF[key]


@pytest.mark.parametrize("kind", ["greedy", "seeded"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_staged_tokens_equal_reference(mode, kind):
    eng = ServeEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                      device="cpu", decode_kernel=True, **MODES[mode])
    got = tokens(eng, requests(Request, kind))
    assert got == ref_tokens(mode, kind)
    st = eng.graph_stats()
    assert st["eager"] >= MAX_NEW - 1 and st["captures"] == 0
    if kind == "greedy":
        for i, p in enumerate(PROMPTS):
            assert eng.generate([p], max_new_tokens=MAX_NEW)[0] == got[i]


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "ssm", "hybrid"])
def test_only_the_dense_kernel_tick_is_staged(family):
    """Only a kernel engine's tick is staged (``decode_kernel=True``), for
    every decoding family; without the kernels nothing is."""
    for kw in ({}, {"decode_kernel": True}):
        eng = ServeEngine.__new__(ServeEngine)
        eng._decode_kernel = bool(kw)
        eng.cfg = dataclasses.replace(CFG, family=family)
        assert eng._staged == bool(kw)
        if family == "dense":
            eng = ServeEngine(CFG, port_params(), n_slots=2,
                              max_len=MAX_LEN, device="cpu", **kw)
            assert eng._staged == bool(kw)


# ---------------------------------------------------------------------------
# The CapsNet forward
# ---------------------------------------------------------------------------


def _deployed(routing="cuda", ref_routing="pallas"):
    ref_cfg, port_cfg = small_cfgs()
    ref_params_, port_params_ = paired_params(ref_cfg, seed=5)
    ref_dep = (RefPipeline(ref_cfg, params=ref_params_)
               .prune(0.6, 0.9, type_keep=2).compact()
               .compile(routing=ref_routing))
    dep = (FastCapsPipeline(port_cfg, params=port_params_, device="cpu")
           .prune(0.6, 0.9, type_keep=2).compact().compile(routing=routing))
    return ref_dep, dep


def test_capsule_engine_classes_equal_reference():
    ref_dep, dep = _deployed()
    eng = dep.serve(batch_size=4)
    eng.warmup()
    ref_eng = ref_dep.serve(batch_size=4)
    frames = [images(100 + i, n, dep.cfg) for i, n in enumerate((3, 5, 1))]
    for i, x in enumerate(frames):
        eng.submit(ImageRequest(images=x, rid=i))
        ref_eng.submit(RefImageRequest(images=x, rid=i))
    done = {c.rid: c for c in eng.run_until_idle()}
    ref_done = {c.rid: c for c in ref_eng.run_until_idle()}
    for i in range(len(frames)):
        np.testing.assert_array_equal(done[i].classes, ref_done[i].classes)
        np.testing.assert_allclose(done[i].lengths, ref_done[i].lengths,
                                   atol=1e-4)
    st = eng.graph_stats()
    assert st["eager"] == eng.stats().ticks + 1     # the warm-up's shape
    assert st["captures"] == st["replays"] == 0


def test_staged_forward_equals_the_eager_one():
    _, dep = _deployed()
    x = torch.from_numpy(images(7, 4, dep.cfg))
    assert torch.equal(dep.forward(x), dep._forward_eager(x))
    # a graph per input shape and tuning policy (off here)
    assert set(dep._graphs) == {((4,) + tuple(x.shape[1:]), torch.float32,
                                 None)}


def test_two_forward_results_do_not_alias():
    _, dep = _deployed()
    x1 = torch.from_numpy(images(1, 4, dep.cfg))
    x2 = torch.from_numpy(images(2, 4, dep.cfg))
    a = dep.forward(x1)
    a_copy = a.clone()
    b = dep.forward(x2)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, a_copy)            # b did not overwrite a
    assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# CapturedCall's bookkeeping, CUDA stubbed
# ---------------------------------------------------------------------------


class StubGraph:
    """torch.cuda.CUDAGraph's stand-in: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def stub_cuda(monkeypatch):
    """A CapturedCall on CPU tensors that captures and replays: the
    streams, the pool and the capture context are stubs, the capture runs
    the function (as a capture records it) without launching anything."""
    import contextlib

    made = []

    class Stream:
        def wait_stream(self, other):
            pass

    def capture(g, pool=None, stream=None, capture_error_mode=None):
        made.append(g)
        return contextlib.nullcontext()

    monkeypatch.setattr(graphs, "active", lambda device: True)
    monkeypatch.setattr(graphs, "_stream", lambda device: Stream())
    monkeypatch.setattr(graphs, "_pool", lambda device: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: None)
    return made


def _launching(x):
    """A body that 'launches' one sampling kernel and two paged decode
    bodies, as the counters see it."""
    sampling_kernel.fused_sampling_cuda.launches += 1
    attn_kernel.decode_attention_cuda.launches += 2
    attn_kernel.decode_attention_cuda.launches_by_body["paged"] += 2
    return x * 2, x + 1


def test_replay_adds_the_capture_launch_counts_once(stub_cuda):
    x = torch.arange(4, dtype=torch.float32)
    call = graphs.CapturedCall(_launching, {"x": x.clone()}, keep=(1,))
    before = graphs.counters()
    out = call()                          # warm-up run (its launches), capture
    assert torch.equal(out[0], x * 2)
    grown = graphs.count_delta(before, graphs.counters())
    assert grown == call.delta == {
        ("fused_sampling_cuda", "launches", None): 1,
        ("decode_attention_cuda", "launches", None): 2,
        ("decode_attention_cuda", "launches_by_body", "paged"): 2}
    assert call.stats["captures"] == 1 and len(stub_cuda) == 1
    for n in range(1, 4):
        call()
        assert stub_cuda[0].replays == n
        assert graphs.count_delta(before, graphs.counters()) == {
            k: v * (n + 1) for k, v in call.delta.items()}
    assert call.stats["replays"] == 3


def test_replayed_outputs_are_cloned_except_kept(stub_cuda):
    call = graphs.CapturedCall(_launching, {"x": torch.ones(3)}, keep=(1,))
    call()
    a, kept_a = call()
    b, kept_b = call()
    static, kept = call._out
    assert kept_a is kept and kept_b is kept          # valid until the next
    assert a.data_ptr() != static.data_ptr() != b.data_ptr()
    assert a.data_ptr() != b.data_ptr()


def test_moved_tensor_recaptures(stub_cuda):
    """A tensor the graph reads in place that moved since the capture
    re-captures (counted): a replay never reads a stale address."""
    cache = torch.zeros(4)
    call = graphs.CapturedCall(lambda x: x + cache, {"x": torch.ones(4)})
    call(reads=[cache])
    call(reads=[cache])
    assert call.stats["recaptures"] == 0 and call.stats["replays"] == 1
    moved = torch.zeros(4)
    call(reads=[moved])
    assert call.stats["recaptures"] == 1 and call.stats["captures"] == 2
    assert call.stats["replays"] == 1          # the moved call captured
    call(reads=[moved])
    assert call.stats["replays"] == 2 and len(stub_cuda) == 2


def test_tuner_and_build_refuse_inside_a_capture(stub_cuda, monkeypatch,
                                                 tmp_path):
    spec = kernel_registry.registry.get("taylor_softmax")
    cache = tuning.TuneCache(str(tmp_path / "autotune.json"))

    def tunes(x):
        tuning.autotune(spec, (x,), {}, cache=cache,
                        timer=lambda fn, **kw: 1.0)

    with pytest.raises(graphs.GraphError, match="autotune"):
        graphs.CapturedCall(tunes, {"x": torch.ones(2, 8)})()
    monkeypatch.setattr(build, "_library", None)

    def builds(x):
        if graphs.capturing():            # the warm-up needs no library
            build.load_library()

    with pytest.raises(graphs.GraphError, match="library"):
        graphs.CapturedCall(builds, {"x": torch.ones(2)})()
    assert not graphs.capturing()


def test_a_failed_capture_raises_and_keeps_the_counters(stub_cuda):
    calls = []

    def body(x):
        calls.append(1)
        sampling_kernel.fused_sampling_cuda.launches += 1
        if len(calls) == 2:               # the capture, not the warm-up
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x

    call = graphs.CapturedCall(body, {"x": torch.ones(2)})
    before = graphs.counters()
    with pytest.raises(graphs.GraphError, match="capture failed"):
        call()
    assert graphs.count_delta(before, graphs.counters()) == {
        ("fused_sampling_cuda", "launches", None): 1}    # the warm-up only


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_tick_replays_through_the_stubbed_graph(mode, stub_cuda,
                                                       monkeypatch):
    """The staged tick on the stubbed capture: the first decode tick
    captures, later ones replay, and the tokens are the unstaged
    engine's."""
    eng = ServeEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                      device="cpu", decode_kernel=True, **MODES[mode])
    want = tokens(Unstaged(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                           device="cpu", decode_kernel=True, **MODES[mode]),
                  requests(Request, "seeded"))

    def replay(graph):
        """As the device would: the captured work again, on the static
        rows, into the static outputs."""
        sh = eng._shards[0]
        for static, new in zip(sh.tick._out,
                               eng._tick_body(sh, sh.tick.inputs["rows"])):
            static.copy_(new)

    monkeypatch.setattr(StubGraph, "replay", replay)
    got = tokens(eng, requests(Request, "seeded"))
    st = eng.graph_stats()
    assert st["captures"] == 1 and st["replays"] >= 1
    assert got == want


# ---------------------------------------------------------------------------
# graph-purity over the captured bodies
# ---------------------------------------------------------------------------

CAPTURED = (
    (port_engine.ServeEngine._tick_body, "ServeEngine", "return kernels"),
    (port_pipeline.DeployedCapsNet._forward_body, "DeployedCapsNet",
     "return capsnet_lib"),
    (kernel_registry.fused_sampling_rows, None, "return registry.call"),
)


# the tensor each planted ``.item()`` reads
PLANTED_ON = {"ServeEngine": "sampling", "DeployedCapsNet": "images",
              None: "rows"}


@pytest.mark.parametrize("fn,cls,anchor", CAPTURED,
                         ids=lambda x: getattr(x, "__qualname__", None))
def test_purity_flags_a_planted_item(fn, cls, anchor, tmp_path):
    src = textwrap.dedent(inspect.getsource(fn))
    lines = src.splitlines()
    at = next(i for i, ln in enumerate(lines) if anchor in ln)
    indent = lines[at][:len(lines[at]) - len(lines[at].lstrip())]
    lines.insert(at, f"{indent}_ = {PLANTED_ON[cls]}.item()")
    body = "\n".join(lines)
    if cls is not None:
        body = f"class {cls}:\n" + textwrap.indent(body, "    ")
    (tmp_path / "mod.py").write_text("import torch\n\n\n" + body + "\n")
    target = f"mod:{cls}.{fn.__name__}" if cls else f"mod:{fn.__name__}"
    project = Project.load([tmp_path], root=tmp_path)
    kept, _ = apply_suppressions(project, list(GraphPurityChecker(
        (Root("ref.py:1 f", (target,)),)).run(project)))
    codes = [(f.code, f.path) for f in kept]
    assert ("host-sync", "mod.py") in codes


def test_purity_finds_nothing_in_the_captured_bodies():
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
    project = Project.load([src], root=src.parent.parent)
    targets = ("repro_torch.serving.engine:ServeEngine._tick_body",
               "repro_torch.deploy.pipeline:DeployedCapsNet._forward_body",
               "repro_torch.kernels.registry:fused_sampling_rows")
    kept, _ = apply_suppressions(project, list(GraphPurityChecker(
        (Root("ref.py:1 f", targets),)).run(project)))
    assert kept == []


# ---------------------------------------------------------------------------
# ROADMAP §C Open 2: tuned decode configs do not follow the batch
# ---------------------------------------------------------------------------


def _decode_args(b, paged=False):
    case = {"dims": (b, 1024, 32, 8, 64), "valid": (700,) * b}
    if paged:
        case["paged"] = (8 * 64, 16, 64)
    spec = kernel_registry.registry.get("decode_attention")
    return spec, spec.make_example(case)


@pytest.mark.parametrize("paged", [False, True])
def test_tuned_decode_is_keyed_without_the_batch(paged, monkeypatch,
                                                 tmp_path):
    """A tuned decode config is looked up under one key at 3 slots and at
    8, so the tuned launch plan (kv_splits, threads: the sums of a slot's
    row) is the same at both; a batch in the key would tune each batch
    apart."""
    spec, (args8, kw8) = _decode_args(8, paged)
    _, (args3, kw3) = _decode_args(3, paged)
    # as on the card (a CPU tensor is never tuned)
    monkeypatch.setattr(tuning, "backend_of", lambda args: "cuda")
    assert (tuning.cache_key_for(spec, args8)
            == tuning.cache_key_for(spec, args3))
    cache = tuning.TuneCache(str(tmp_path / "autotune.json"))
    cache.put(tuning.cache_key_for(spec, args8),
              {"kv_splits": 1, "threads": 128}, {})
    monkeypatch.setattr(tuning, "default_cache", lambda: cache)

    def no_tuning(*a, **kw):
        raise AssertionError("tuned again at another batch")

    monkeypatch.setattr(tuning, "autotune", no_tuning)
    reg = kernel_registry.registry
    plan8 = reg.resolve_config("decode_attention", *args8, tune=True, **kw8)
    plan3 = reg.resolve_config("decode_attention", *args3, tune=True, **kw3)
    assert plan8 == plan3 == {"kv_splits": 1, "threads": 128}
    assert spec.batch_free_key

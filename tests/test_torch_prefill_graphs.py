"""The reference's remaining compiled serving entry points on the CPU: the
staged prefill, paged prefill, gather and inject (``ServeEngine._run_staged``).

On the card the dense family's admission replays CUDA graphs, one per
block and shape key (``(nb, plen)``, ``(nb, plen, off)``, the rows of a
gather or an inject), the counterparts of the reference's jitted
``_prefill``, ``_prefill_paged``, ``_gather`` and ``_inject``; on the CPU
the same staged bodies run eagerly.  Held here:

* each staged call, run eagerly, gives what the unstaged code gives bit
  for bit: every first-token logits row and every cache or pool leaf after
  a serve, for the ragged prefill, the paged prefill over bf16 and int8
  pages and the continuation after a shared prefix;
* a preempted-and-resumed request (the staged gather and inject) stays
  token-identical to the reference ``ServeEngine``'s;
* with the capture stubbed, later admissions replay (the staged buffers
  carry each call's inputs) and the tokens do not change; a host read of a
  tensor (``int()``, ``.item()``, ``.cpu()``, ...) inside the stubbed
  capture raises, as it invalidates a capture on the card: one-token
  prompts (a prefill bucket of one row) admit without one;
* ``lm.scatter_cache_rows``, ``PagePool.write_prefill_pages`` and
  ``scatter_residual_rows`` drop a pad row on the device, as the host-read
  versions did;
* ``graph-purity`` rooted at the staged bodies finds no host sync, and
  finds a planted one;
* no garbage collection runs inside a capture (a collected engine's graph
  destroyed mid-capture invalidated it on the card).
"""

import contextlib
import dataclasses
import inspect
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert, graphs
from repro_torch.analysis import Project, apply_suppressions
from repro_torch.analysis.checkers.purity import GraphPurityChecker, Root
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig, tree_leaves
from repro_torch.serving import PagePool, PriorityScheduler, Request
from repro_torch.serving import ServeEngine
from repro_torch.serving import engine as port_engine

torch.set_num_threads(1)

PAGE = 8
MAX_LEN = 32
TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")
REF_CFG = RefLMConfig(**TINY)
CFG = dataclasses.replace(LMConfig(**TINY), attn_impl="cuda")
MODES = {"dense": {}, "paged": dict(page_size=PAGE),
         "paged_int8": dict(page_size=PAGE, quantize_pages=True)}
SHARED = [3, 1, 4, 1, 5, 9, 2, 6]          # one full page
# ragged prompts, two of them after a shared page (a continuation prefill
# once the first has registered it), one of a single token past it
PROMPTS = [SHARED + [7, 7, 8], [5, 6, 7, 8, 9, 10, 11], [2, 4],
           SHARED + [12], SHARED + [13, 14, 15, 16, 17, 18, 19, 20, 21]]
_REF = {}


def ref_params():
    if "params" not in _REF:
        _REF["params"] = ref_lm.init(REF_CFG, jax.random.key(0))
    return _REF["params"]


def port_params():
    return convert.params_from_numpy(jax.tree.map(np.asarray, ref_params()))


class Unstaged(ServeEngine):
    """The engine with every staged call unstaged: the eager code as it
    was, what the staged calls are held against."""

    _staged = False


def requests(n_new=4):
    kw = dict(temperature=0.8, top_k=8, top_p=0.95)
    return [Request(prompt=list(p), max_new_tokens=n_new, rid=i,
                    seed=500 + i, **(kw if i % 2 else {}))
            for i, p in enumerate(PROMPTS)]


def serve_recorded(eng, reqs):
    """Tokens, every first-token logits row (by rid) and the state leaves
    after ``reqs``, served in two waves (the second meets the first's
    prefix pages)."""
    rows = {}
    inner = eng._sample_task_row

    def on_host(logits_row, task, pos):
        rows[task.rid] = np.array(logits_row, np.float32)
        return inner(logits_row, task, pos)

    eng._sample_task_row = on_host
    done = eng.serve(reqs[:2]) + eng.serve(reqs[2:])
    sh = eng._shards[0]
    state = tree_leaves(sh.caches if sh.caches is not None
                        else [sh.pool, sh.residual or {}])
    return {c.rid: list(c.tokens) for c in done}, rows, state


@pytest.mark.parametrize("mode", sorted(MODES))
def test_staged_admission_equals_the_unstaged_code(mode):
    params = port_params()
    got = {}
    for name, cls in (("staged", ServeEngine), ("unstaged", Unstaged)):
        eng = cls(CFG, params, n_slots=2, max_len=MAX_LEN, device="cpu",
                  decode_kernel=True, **MODES[mode])
        got[name] = serve_recorded(eng, requests())
        got[name + "_engine"] = eng
    (tok_a, rows_a, state_a), (tok_b, rows_b, state_b) = (got["staged"],
                                                          got["unstaged"])
    assert tok_a == tok_b
    assert sorted(rows_a) == sorted(rows_b) == list(range(len(PROMPTS)))
    for rid in rows_a:
        assert rows_a[rid].tobytes() == rows_b[rid].tobytes(), rid
    assert len(state_a) == len(state_b)
    for a, b in zip(state_a, state_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    eng = got["staged_engine"]
    kind = "prefill" if mode == "dense" else "paged prefill"
    st = eng.graph_stats(kind)
    assert st["eager"] >= 2 and st["captures"] == 0
    keys = [k for k in eng._shards[0].calls if k[0] == kind]
    if mode != "dense":
        # a ragged prefill and a continuation after the shared page, one
        # of them a single token
        assert any(k[1][2] == 0 for k in keys)
        assert any(k[1][2] == PAGE for k in keys)
        assert any(k[1][1] == 1 and k[1][2] > 0 for k in keys)


def test_preempted_request_resumes_through_staged_gather_and_inject():
    """The victim decodes, an urgent request evicts it (the staged gather),
    it resumes in the slot (the staged inject): its tokens are the
    undisturbed run's and the reference's, and the caches end as the
    unstaged engine's."""
    victim = dict(prompt=[1, 2, 3], max_new_tokens=8, rid=0, seed=42,
                  priority=1, temperature=0.8, top_k=8, top_p=0.95)
    urgent = dict(prompt=[9, 9], max_new_tokens=2, rid=1, seed=43,
                  priority=0, temperature=0.8, top_k=8, top_p=0.95)
    ref = RefServeEngine(REF_CFG, ref_params(), n_slots=1, max_len=MAX_LEN)
    [rc] = ref.serve([RefRequest(**victim)])
    caches = {}
    for cls in (ServeEngine, Unstaged):
        eng = cls(CFG, port_params(), n_slots=1, max_len=MAX_LEN,
                  device="cpu", decode_kernel=True,
                  scheduler=PriorityScheduler())
        eng.submit(Request(**victim))
        eng.tick()
        eng.tick()
        eng.submit(Request(**urgent))
        comps = {c.rid: list(c.tokens) for c in eng.run_until_idle()}
        assert eng.stats().preempted >= 1
        assert comps[0] == list(rc.tokens)
        caches[cls] = tree_leaves(eng._caches)
        if cls is ServeEngine:
            assert eng.graph_stats("gather")["eager"] >= 1
            assert eng.graph_stats("inject")["eager"] >= 1
    for a, b in zip(caches[ServeEngine], caches[Unstaged]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Replays, the capture stubbed
# ---------------------------------------------------------------------------


class StubGraph:
    """A captured call's graph: a replay runs its body again on the static
    inputs into the static outputs (the counters set back: the replay adds
    the capture's counts)."""

    def __init__(self, call):
        self.call = call

    def replay(self):
        before = graphs.counters()
        new = self.call.fn(**self.call.inputs)
        graphs.restore_counts(before)
        old = [] if self.call._out is None else tree_leaves(self.call._out)
        for s, n in zip(old, [] if new is None else tree_leaves(new)):
            s.copy_(n)


# what reads a tensor back to the host: inside a capture on the card each
# one synchronises the stream, which invalidates the capture
HOST_READS = ("item", "tolist", "cpu", "numpy", "__array__", "__int__",
              "__float__", "__bool__", "__index__")
_IN_CAPTURE = [0]


def trap_host_reads(monkeypatch):
    """Make every HOST_READS method of a tensor raise while a stubbed
    capture runs."""
    for name in HOST_READS:
        inner = getattr(torch.Tensor, name)

        def read(self, *a, _inner=inner, _name=name, **kw):
            if _IN_CAPTURE[0]:
                raise AssertionError(f"host read Tensor.{_name} inside a "
                                     f"capture")
            return _inner(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, read)


@contextlib.contextmanager
def in_capture():
    _IN_CAPTURE[0] += 1
    try:
        yield
    finally:
        _IN_CAPTURE[0] -= 1


def _capture(self, ptrs):
    out = self.fn(**self.inputs)
    before = graphs.counters()
    with in_capture():
        static = self.fn(**self.inputs)
    after = graphs.counters()
    graphs.restore_counts(before)
    self._bump("captures")
    self._graph, self._out, self._ptrs = StubGraph(self), static, ptrs
    self._delta = graphs.count_delta(before, after)
    return out


def stub_capture(monkeypatch):
    """Every staged call on the CPU captures (stubbed: its body run on
    the static inputs, host reads raising) and replays."""
    monkeypatch.setattr(graphs, "active",
                        lambda device: not getattr(graphs._local, "eager", 0))
    monkeypatch.setattr(graphs.CapturedCall, "_capture", _capture)
    trap_host_reads(monkeypatch)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_admission_replays_through_the_stubbed_graph(mode, monkeypatch):
    """Served twice with the capture stubbed: the first serve captures each
    admission key, the second replays them from their staged buffers, and
    both give the unstaged engine's tokens."""
    want = serve_recorded(Unstaged(
        CFG, port_params(), n_slots=2, max_len=MAX_LEN, device="cpu",
        decode_kernel=True, **MODES[mode]), requests())[0]
    stub_capture(monkeypatch)
    eng = ServeEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                      device="cpu", decode_kernel=True, **MODES[mode])
    assert serve_recorded(eng, requests())[0] == want
    # the first two again, twice: a paged engine meets its prefix pages in
    # the first of these (new continuation shapes), replays in the second
    for _ in range(2):
        again = eng.serve(requests()[:2])
        assert {c.rid: list(c.tokens) for c in again} == {
            r: t for r, t in want.items() if r < 2}
    kind = "prefill" if mode == "dense" else "paged prefill"
    st = eng.graph_stats(kind)
    assert st["captures"] >= 2 and st["replays"] >= 1
    assert st["recaptures"] == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_token_prompts_admit_without_a_host_read(mode, monkeypatch):
    """Prompts of one token only: the dense prefill's bucket and the
    paged prefill's span are one row, the attention's one-token branch.
    Served twice with the capture stubbed (host reads raising inside it),
    they capture and then replay a one-row prefill, and give the unstaged
    engine's tokens."""
    def one_token():
        return [Request(prompt=[p], max_new_tokens=3, rid=i, seed=700 + i,
                        temperature=0.8 if i % 2 else 0.0, top_k=8)
                for i, p in enumerate((7, 3, 12))]

    want = {c.rid: list(c.tokens) for c in Unstaged(
        CFG, port_params(), n_slots=2, max_len=MAX_LEN, device="cpu",
        decode_kernel=True, **MODES[mode]).serve(one_token())}
    stub_capture(monkeypatch)
    eng = ServeEngine(CFG, port_params(), n_slots=2, max_len=MAX_LEN,
                      device="cpu", decode_kernel=True, **MODES[mode])
    for _ in range(2):
        assert {c.rid: list(c.tokens)
                for c in eng.serve(one_token())} == want
    kind = "prefill" if mode == "dense" else "paged prefill"
    assert any(k[0] == kind and k[1][1] == 1 for k in eng._shards[0].calls)
    st = eng.graph_stats(kind)
    assert st["captures"] >= 1 and st["replays"] >= 1
    assert st["recaptures"] == 0


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "failed"])
def test_no_garbage_collection_inside_a_capture(fails, monkeypatch):
    """A graph collected with an unreachable engine's reference cycle would
    destroy itself inside another capture, which forbids that and is
    invalidated: the collector is off while a capture runs, and on again
    after it, whether the capture succeeds or fails."""
    import contextlib
    import gc

    seen = []

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capture(g, pool=None, stream=None, capture_error_mode=None):
        seen.append(gc.isenabled())
        yield
        if fails:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphs, "active", lambda device: True)
    monkeypatch.setattr(graphs, "_stream", lambda device: Stream())
    monkeypatch.setattr(graphs, "_pool", lambda device: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    assert gc.isenabled()
    call = graphs.CapturedCall(lambda x: x + 1, {"x": torch.ones(2)})
    if fails:
        with pytest.raises(graphs.GraphError):
            call()
    else:
        call()
    assert seen == [False] and gc.isenabled()


# ---------------------------------------------------------------------------
# The row and page writes drop their pads on the device
# ---------------------------------------------------------------------------


def test_scatter_cache_rows_drops_pads_on_the_device():
    gen = torch.Generator().manual_seed(0)
    caches = port_lm.make_caches(CFG, 4, 8, device="cpu")
    for leaf in tree_leaves(caches):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    rows = port_lm.make_caches(CFG, 3, 8, device="cpu")
    for leaf in tree_leaves(rows):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    for idx in ([2, 4, 0], [9, 9, 9], [-1, 1, 7]):
        want = [c.clone() for c in tree_leaves(caches)]
        keep = [i for i, s in enumerate(idx) if 0 <= s < 4]
        for w, n in zip(want, tree_leaves(rows)):
            w[:, [idx[i] for i in keep]] = n[:, keep].to(w.dtype)
        got = [c.clone() for c in tree_leaves(caches)]
        out = port_lm.scatter_cache_rows(
            CFG, torch.tensor(idx, dtype=torch.int32), rows,
            {"kv": dict(zip(("k", "v"), got))})
        for g, w in zip(tree_leaves(out), want):
            assert torch.equal(g, w), idx


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_write_prefill_pages_drops_the_sentinel_on_the_device(quantize):
    pool_lib = PagePool(CFG, n_slots=2, max_len=MAX_LEN, page_size=PAGE,
                        quantize=quantize)
    pool = pool_lib.init_pool_arrays("cpu")
    gen = torch.Generator().manual_seed(1)
    sub = port_lm.make_caches(CFG, 2, 3 * PAGE, device="cpu")
    for leaf in tree_leaves(sub):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    n = pool_lib.n_pages
    page_map = np.array([[5, n, 1], [n, 0, n]])      # sentinels dropped
    want = {k: v.clone() for k, v in pool.items()}
    for b, row in enumerate(page_map):
        for j, p in enumerate(row):
            if p >= n:
                continue
            for key in ("kv/k", "kv/v"):
                span = sub["kv"][key[-1]][:, b, j * PAGE:(j + 1) * PAGE]
                if quantize:
                    from repro_torch.models.attention import \
                        quantize_kv_rows
                    q, sc = quantize_kv_rows(span)
                    want[key][:, p] = q
                    want[key + "_scale"][:, p] = sc
                else:
                    want[key][:, p] = span.to(want[key].dtype)
    for pm in (page_map, torch.from_numpy(page_map).to(torch.int32)):
        got = {k: v.clone() for k, v in pool.items()}
        pool_lib.write_prefill_pages(got, sub, pm, 0)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# graph-purity over the staged bodies
# ---------------------------------------------------------------------------

STAGED = ("repro_torch.serving.engine:ServeEngine._prefill_body",
          "repro_torch.serving.engine:ServeEngine._prefill_paged_body",
          "repro_torch.serving.engine:ServeEngine._prefill_scatter",
          "repro_torch.serving.engine:ServeEngine._prefill_paged_impl",
          "repro_torch.serving.engine:ServeEngine._inject_rows.body",
          "repro_torch.models.lm:scatter_cache_rows",
          "repro_torch.models.lm:gather_cache_rows",
          "repro_torch.serving.pages:PagePool.write_prefill_pages",
          "repro_torch.serving.pages:PagePool.scatter_residual_rows",
          "repro_torch.serving.pages:PagePool.make_continuation_caches")


def test_purity_finds_nothing_in_the_staged_bodies():
    src = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
    project = Project.load([src], root=src.parent.parent)
    kept, _ = apply_suppressions(project, list(GraphPurityChecker(
        (Root("ref.py:1 f", STAGED),)).run(project)))
    assert kept == []


@pytest.mark.parametrize("method", ["_prefill_body", "_prefill_paged_body"])
def test_purity_flags_a_planted_host_read(method, tmp_path):
    fn = getattr(port_engine.ServeEngine, method)
    lines = textwrap.dedent(inspect.getsource(fn)).splitlines()
    at = next(i for i, ln in enumerate(lines) if "return self." in ln)
    indent = lines[at][:len(lines[at]) - len(lines[at].lstrip())]
    lines.insert(at, f"{indent}_ = rows.cpu()")
    body = "class ServeEngine:\n" + textwrap.indent("\n".join(lines), "    ")
    (tmp_path / "mod.py").write_text("import torch\n\n\n" + body + "\n")
    project = Project.load([tmp_path], root=tmp_path)
    kept, _ = apply_suppressions(project, list(GraphPurityChecker(
        (Root("ref.py:1 f", (f"mod:ServeEngine.{method}",)),)).run(project)))
    assert ("host-sync", "mod.py") in [(f.code, f.path) for f in kept]

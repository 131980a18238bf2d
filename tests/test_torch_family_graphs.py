"""The moe, vlm, ssm and hybrid families' staged serving on the CPU.

With ``decode_kernel=True`` every decoding family's decode tick and
admission are staged (``ServeEngine._staged``) and, on the card, replayed
from CUDA graphs: the counterparts of the reference's jitted ``_decode``,
``_decode_paged``, ``_prefill``, ``_prefill_paged``, ``_gather`` and
``_inject`` (``src/repro/serving/engine.py:144-167``).  On the CPU the same
staged bodies run eagerly.  Fixtures are the tiny models of
``tests/test_torch_family_engine.py`` (moe, vlm) and
``tests/test_torch_recurrent.py`` (ssm, hybrid), the reference's parameters
converted leaf by leaf; each family is held in each cache mode it serves
(dense slots, bf16 and int8 pages for moe and vlm; dense slots only for
the recurrent ones, which ``PagePool`` refuses in both packages).  Held:

* the staged engine's greedy and seeded tokens equal the unstaged
  engine's and the reference ``ServeEngine``'s, exactly;
* after a serve every cache, pool and recurrent state leaf and every
  first-token logits row equal the unstaged engine's bit for bit: the
  staged tick drops the tree ``decode_step`` returns, so a leaf the model
  rebound instead of writing in place would go stale here;
* each leaf the unstaged decode and prefill calls return is the storage
  that was passed in (its ``data_ptr``), and the call wrote into it;
* with the capture stubbed, a second serve replays every key (the vlm's
  paged view tick and the recurrent exact-length groups included), with
  every host read of a tensor raising inside the capture, one-token
  prompts too;
* preemption and the disaggregated handoff go through the staged gather
  and inject;
* ``graph-purity`` rooted at the families' decode and prefill paths finds
  nothing (a key test on a dict, ``"router_b" in params``, is decided on
  the host), and still flags a ``.item()`` planted in the moe path.
"""

import inspect
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_family_engine as fam
import test_torch_recurrent as rec
from repro.models.common import LMConfig as RefLMConfig
from repro.models.common import SSMConfig as RefSSMConfig
from repro.models.common import XLSTMConfig as RefXLSTMConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch.analysis import Project, apply_suppressions
from repro_torch.analysis.checkers.purity import GraphPurityChecker, Root
from repro_torch.models import moe as port_moe
from repro_torch.models.common import tree_leaves
from repro_torch.serving import (PriorityScheduler, Request, ServeEngine,
                                 disaggregated_lm_engine)
from repro_torch.serving.disagg import _flatten
from test_torch_prefill_graphs import stub_capture

torch.set_num_threads(1)

MAX_LEN = 32
MODES = fam.CACHE_MODES
CASES = [("moe", "dense"), ("moe", "paged"), ("moe", "paged_int8"),
         ("vlm", "dense"), ("vlm", "paged"), ("vlm", "paged_int8"),
         ("ssm", "dense"), ("hybrid", "dense")]
FAMILIES = ("moe", "vlm", "ssm", "hybrid")
# ragged prompts, two of one length (a recurrent group of two rows)
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4], [3, 1, 4]]
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
_REF = {}


def models(family):
    """(reference config, reference parameters, the port's kernel-path
    config, the port's parameters converted leaf by leaf)."""
    if family in ("moe", "vlm"):
        return (fam.cfgs(family)[0], fam.ref_params(family),
                fam.port_cfg(family, attn_impl="cuda"),
                fam.port_params(family))
    jp = rec.tiny_params(family)
    return (rec.tiny(RefLMConfig, RefSSMConfig, RefXLSTMConfig, family), jp,
            rec.tiny_cfg(family, attn_impl="cuda"),
            convert.params_from_numpy(jax.tree.map(np.asarray, jp)))


class Unstaged(ServeEngine):
    """The engine with every staged call unstaged: the eager code the
    staged calls are held against."""

    _staged = False


def engine(family, mode, cls=ServeEngine, n_slots=2, **kw):
    _, _, cfg, params = models(family)
    return cls(cfg, params, n_slots=n_slots, max_len=MAX_LEN, device="cpu",
               decode_kernel=True, **MODES[mode], **kw)


def requests(request_cls=Request, prompts=PROMPTS, n_new=4):
    """Greedy and seeded requests (the odd ones sample, seed 500 + rid)."""
    return [request_cls(prompt=list(p), max_new_tokens=n_new, rid=i,
                        seed=500 + i, **(SAMPLING_KW if i % 2 else {}))
            for i, p in enumerate(prompts)]


def tokens(eng, reqs):
    return {c.rid: list(c.tokens) for c in eng.serve(reqs)}


def state_leaves(eng):
    sh = eng._shards[0]
    return tree_leaves(sh.caches if sh.caches is not None
                       else [sh.pool, sh.residual or {}])


def ref_tokens(family, mode):
    key = (family, mode)
    if key not in _REF:
        ref_cfg, jp, _, _ = models(family)
        eng = RefServeEngine(ref_cfg, jp, n_slots=2, max_len=MAX_LEN,
                             **MODES[mode])
        _REF[key] = tokens(eng, requests(RefRequest))
    return _REF[key]


def prefill_kind(mode):
    return "prefill" if mode == "dense" else "paged prefill"


# ---------------------------------------------------------------------------
# Tokens and leaves against the unstaged code and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,mode", CASES)
def test_staged_tokens_equal_unstaged_and_reference(family, mode):
    staged = engine(family, mode)
    got = tokens(staged, requests())
    assert got == tokens(engine(family, mode, Unstaged), requests())
    assert got == ref_tokens(family, mode)
    assert staged.graph_stats("tick")["eager"] >= 1
    st = staged.graph_stats(prefill_kind(mode))
    assert st["eager"] >= 1 and st["captures"] == 0


def serve_recorded(eng, reqs):
    """Tokens, every first-token logits row (by rid) and the state leaves
    after ``reqs``, served in two waves."""
    rows = {}
    inner = eng._sample_task_row

    def on_host(logits_row, task, pos):
        rows[task.rid] = np.array(logits_row, np.float32)
        return inner(logits_row, task, pos)

    eng._sample_task_row = on_host
    done = eng.serve(reqs[:2]) + eng.serve(reqs[2:])
    return {c.rid: list(c.tokens) for c in done}, rows, state_leaves(eng)


@pytest.mark.parametrize("family,mode", CASES)
def test_staged_leaves_equal_the_unstaged_engine_bit_for_bit(family, mode):
    """Several decode ticks later every cache, pool and state leaf is the
    unstaged engine's bit for bit (the staged tick keeps no returned tree:
    only in-place writes reach the engine's storage), and so is every
    first-token logits row."""
    (tok_a, rows_a, state_a), (tok_b, rows_b, state_b) = (
        serve_recorded(engine(family, mode, cls), requests(n_new=6))
        for cls in (ServeEngine, Unstaged))
    assert tok_a == tok_b
    assert sorted(rows_a) == sorted(rows_b) == list(range(len(PROMPTS)))
    for rid in rows_a:
        assert rows_a[rid].tobytes() == rows_b[rid].tobytes(), rid
    assert len(state_a) == len(state_b)
    for a, b in zip(state_a, state_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(bool(a.ne(0).any()) for a in state_a)


def written(before, after, path):
    """Whether a leaf was written: a vlm's cross cache, which a serve
    without image features only reads, is left as it was."""
    if "cross" in path:
        return torch.equal(before, after)
    return not torch.equal(before, after)


@pytest.mark.parametrize("family,mode", CASES)
def test_each_returned_leaf_is_the_storage_passed_in(family, mode):
    """The unstaged decode and prefill calls hand back the leaves they were
    given (each ``data_ptr`` the engine's) and wrote into them: what a
    graph replay, which drops the returned tree, relies on."""
    eng = engine(family, mode, Unstaged)
    for r in requests()[:2]:
        eng.submit(r)
    eng.tick()
    eng.tick()
    sh = eng._shards[0]
    state = sh.caches if mode == "dense" else sh.pool
    paths = [p for p, _ in _flatten(state)]
    ptrs = [x.data_ptr() for x in tree_leaves(state)]
    before = [x.clone() for x in tree_leaves(state)]
    tok = torch.from_numpy(eng._tok[:, None].copy())
    pos = torch.from_numpy(eng._pos.copy())
    if mode == "dense":
        _, out = eng._decode(sh, tok, pos, sh.caches)
    else:
        tables = eng._local_tables(sh, eng._pages.tables_snapshot())
        _, out = eng._decode_paged_impl(sh, tok, pos, tables)
    assert [x.data_ptr() for x in tree_leaves(out)] == ptrs
    for p, b, a in zip(paths, before, tree_leaves(state)):
        assert written(b, a, p), p
    if mode != "dense":
        return
    before = [x.clone() for x in tree_leaves(state)]
    _, out = eng._prefill_scatter(sh, np.array([[7, 8, 9]], np.int32),
                                  np.array([3], np.int32),
                                  np.array([1], np.int64), sh.caches)
    assert [x.data_ptr() for x in tree_leaves(out)] == ptrs
    for p, b, a in zip(paths, before, tree_leaves(state)):
        assert written(b, a, p), p


# ---------------------------------------------------------------------------
# Replays, the capture stubbed (every host read of a tensor raising in it)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,mode", CASES)
def test_family_replays_through_the_stubbed_graph(family, mode,
                                                  monkeypatch):
    """Served twice with the capture stubbed: the first serve captures the
    tick and each admission key, the second replays them, and both give
    the unstaged engine's tokens."""
    want = tokens(engine(family, mode, Unstaged), requests())
    stub_capture(monkeypatch)
    eng = engine(family, mode)
    for _ in range(2):
        assert tokens(eng, requests()) == want
    tick = eng.graph_stats("tick")
    assert tick["captures"] == 1 and tick["replays"] >= 1
    st = eng.graph_stats(prefill_kind(mode))
    assert st["captures"] >= 1 and st["replays"] >= 1
    assert eng.graph_stats("all")["recaptures"] == 0


@pytest.mark.parametrize("family,mode", CASES)
def test_family_one_token_prompts_admit_without_a_host_read(family, mode,
                                                            monkeypatch):
    """Prompts of one token (a one-row prefill, for the moe a flattened
    dispatch): captured and then replayed with host reads trapped, the
    unstaged engine's tokens."""
    one = [[7], [3], [12]]

    def reqs():
        return requests(prompts=one, n_new=3)

    want = tokens(engine(family, mode, Unstaged), reqs())
    stub_capture(monkeypatch)
    eng = engine(family, mode)
    for _ in range(2):
        assert tokens(eng, reqs()) == want
    kind = prefill_kind(mode)
    assert any(k[0] == kind and k[1][1] == 1 for k in eng._shards[0].calls)
    st = eng.graph_stats(kind)
    assert st["captures"] >= 1 and st["replays"] >= 1
    assert st["recaptures"] == 0


# ---------------------------------------------------------------------------
# The staged gather and inject: preemption and the handoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_preempted_request_resumes_through_the_staged_gather_and_inject(
        family):
    victim = dict(prompt=[1, 2, 3], max_new_tokens=8, rid=0, seed=42,
                  priority=1, **SAMPLING_KW)
    urgent = dict(prompt=[9, 9], max_new_tokens=2, rid=1, seed=43,
                  priority=0, **SAMPLING_KW)
    [alone] = engine(family, "dense", n_slots=1).serve([Request(**victim)])
    leaves = {}
    for cls in (ServeEngine, Unstaged):
        eng = engine(family, "dense", cls, n_slots=1,
                     scheduler=PriorityScheduler())
        eng.submit(Request(**victim))
        eng.tick()
        eng.tick()
        eng.submit(Request(**urgent))
        comps = {c.rid: list(c.tokens) for c in eng.run_until_idle()}
        assert eng.stats().preempted >= 1
        assert comps[0] == list(alone.tokens)
        leaves[cls] = state_leaves(eng)
        if cls is ServeEngine:
            assert eng.graph_stats("gather")["eager"] >= 1
            assert eng.graph_stats("inject")["eager"] >= 1
    for a, b in zip(leaves[ServeEngine], leaves[Unstaged]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_handoff_goes_through_the_staged_gather_and_inject(family):
    """Disaggregated: the prefill engine's gather and the decode engines'
    inject are staged calls, and the tokens are the reference's."""
    _, _, cfg, params = models(family)
    eng = disaggregated_lm_engine(cfg, params, n_slots=2, max_len=MAX_LEN,
                                  n_decode=2, transport="host_staged",
                                  decode_kernel=True, device="cpu")
    assert tokens(eng, requests()) == ref_tokens(family, "dense")
    assert eng.prefill.graph_stats("gather")["eager"] == len(PROMPTS)
    assert sum(d.graph_stats("inject")["eager"]
               for d in eng.decodes) >= 2
    assert all(d.graph_stats("tick")["eager"] >= 1 for d in eng.decodes)


# ---------------------------------------------------------------------------
# graph-purity over the families' paths
# ---------------------------------------------------------------------------

FAMILY_PATHS = ("repro_torch.models.moe:moe_apply",
                "repro_torch.models.mamba2:mamba2_apply",
                "repro_torch.models.xlstm:mlstm_apply",
                "repro_torch.models.xlstm:slstm_apply",
                "repro_torch.models.attention:cross_attention",
                "repro_torch.models.lm:forward",
                "repro_torch.models.lm:decode_step",
                "repro_torch.models.lm:ragged_prefill_step",
                "repro_torch.serving.pages:PagePool.build_view",
                "repro_torch.serving.pages:PagePool.scatter_decode_rows",
                "repro_torch.serving.engine:ServeEngine._decode_paged_impl",
                "repro_torch.serving.engine:ServeEngine._tick_body",
                "repro_torch.serving.engine:ServeEngine._prefill_body")


def purity(project, targets):
    kept, _ = apply_suppressions(project, list(GraphPurityChecker(
        (Root("ref.py:1 f", targets),)).run(project)))
    return kept


@pytest.mark.parametrize("target", FAMILY_PATHS,
                         ids=lambda t: t.split(":")[1])
def test_purity_finds_nothing_in_the_family_paths(target):
    src = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
    assert purity(Project.load([src], root=src.parent.parent),
                  (target,)) == []


def test_purity_flags_a_planted_item_in_the_moe_path(tmp_path):
    """``moe_apply`` with a ``.item()`` planted before its key test: the
    read is flagged, the key test (``"router_b" in params``) is not."""
    lines = textwrap.dedent(inspect.getsource(port_moe.moe_apply)
                            ).splitlines()
    at = next(i for i, ln in enumerate(lines) if '"router_b" in params' in ln)
    indent = lines[at][:len(lines[at]) - len(lines[at].lstrip())]
    lines.insert(at, f"{indent}_ = logits.item()")
    (tmp_path / "mod.py").write_text(
        "import torch\n\n\n" + "\n".join(lines) + "\n")
    project = Project.load([tmp_path], root=tmp_path)
    found = [(f.code, f.line) for f in purity(project, ("mod:moe_apply",))]
    planted = 4 + at
    assert found == [("host-sync", planted)]

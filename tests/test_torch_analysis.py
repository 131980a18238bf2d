"""capslint for the port (``repro_torch.analysis``), on the CPU.

Each rule gets a planted violation at its exact ``file:line``, a
suppressed variant and a clean variant, ported from
``tests/test_analysis.py``.  On top of that:

* parity: on the same planted sources the port's ``lock-discipline`` and
  ``exception-hygiene`` give the reference's findings, and the findings /
  baseline plumbing fingerprints as the reference's does;
* the ``graph-purity`` root table covers every ``jax.jit`` /
  ``pl.pallas_call`` root the reference's own root finder gives over
  ``src/repro``, and every row resolves in the port;
* ``kernel-legality`` passes the real registry and flags a planted spec at
  each Hopper limit; the three CUDA sources' limits equal
  ``repro_torch.kernels.limits``;
* the repo gate: ``python -m repro_torch.analysis --strict --json`` exits 0
  on the committed tree without importing ``jax`` or ``repro``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import Baseline as RefBaseline
from repro.analysis import Finding as RefFinding
from repro.analysis import Project as RefProject
from repro.analysis.checkers.exceptions import \
    ExceptionHygieneChecker as RefExceptionHygiene
from repro.analysis.checkers.locks import \
    LockDisciplineChecker as RefLockDiscipline
from repro.analysis.checkers.purity import _find_roots as ref_find_roots
from repro_torch.analysis import (Baseline, Finding, Project,
                                  apply_suppressions, default_registry,
                                  sort_findings)
from repro_torch.analysis.__main__ import filter_changed
from repro_torch.analysis.checkers import purity
from repro_torch.analysis.checkers.exceptions import ExceptionHygieneChecker
from repro_torch.analysis.checkers.legality import KernelLegalityChecker
from repro_torch.analysis.checkers.locks import LockDisciplineChecker
from repro_torch.analysis.checkers.purity import GraphPurityChecker, Root
from repro_torch.kernels import limits
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.registry import registry as kernel_registry
from repro_torch.kernels.routing import routing_kernel
from repro_torch.kernels.sampling import kernel as sampling_kernel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_SRC = REPO / "src" / "repro_torch"
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}


def lint(tmp_path, source, checker, name="mod.py", project_cls=Project):
    """Write ``source`` into a throwaway project, run one checker, and
    return (kept, suppressed) findings."""
    (tmp_path / name).write_text(textwrap.dedent(source))
    project = project_cls.load([tmp_path], root=tmp_path)
    findings = list(checker.run(project))
    if project_cls is Project:
        return apply_suppressions(project, findings)
    from repro.analysis import apply_suppressions as ref_apply

    return ref_apply(project, findings)


def locations(findings):
    return [(f.rule, f.code, f.path, f.line) for f in findings]


def records(findings):
    return sorted((f.rule, f.code, f.path, f.line, f.symbol, f.message)
                  for f in findings)


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

LOCKED_SRC = """\
import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = []                      # guarded-by: _lock

    def submit(self, item):
        self._queue.append(item)              # line 10: unguarded

    def submit_ok(self, item):
        with self._lock:
            self._queue.append(item)

    def _drain_locked(self):
        self._queue.clear()

    def nudge(self):
        self._drain_locked()                  # line 20: no lock held

    def nudge_ok(self):
        with self._lock:
            self._drain_locked()
"""

POOL_SRC = """\
import threading


class PagePool:
    def __init__(self):
        self._lock = threading.Lock()
        self._free = [2, 1, 0]            # guarded-by: _lock
        self._prefix_index = {}           # guarded-by: _lock

    def allocate(self):
        return self._free.pop()           # line 11: unguarded

    def register_hash(self, digest, page):
        self._prefix_index[digest] = page  # line 14: unguarded

    def allocate_ok(self):
        with self._lock:
            return self._free.pop()
"""

CLEAN_LOCKED_SRC = """\
import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = []              # guarded-by: _lock
        self._scratch = []

    def submit(self, item):
        with self._lock:
            self._queue.append(item)
        self._scratch.append(item)
"""


class TestLockDiscipline:
    def test_planted_violations_exact_location(self, tmp_path):
        kept, _ = lint(tmp_path, LOCKED_SRC, LockDisciplineChecker())
        assert locations(kept) == [
            ("lock-discipline", "unguarded-mutation", "mod.py", 10),
            ("lock-discipline", "locked-call-unlocked", "mod.py", 20)]

    def test_page_pool_shaped_violation(self, tmp_path):
        kept, _ = lint(tmp_path, POOL_SRC, LockDisciplineChecker())
        assert sorted(locations(kept)) == [
            ("lock-discipline", "unguarded-mutation", "mod.py", 11),
            ("lock-discipline", "unguarded-mutation", "mod.py", 14)]

    def test_suppression(self, tmp_path):
        src = LOCKED_SRC.replace(
            "# line 10: unguarded",
            "# capslint: disable=lock-discipline — test")
        kept, suppressed = lint(tmp_path, src, LockDisciplineChecker())
        assert [f.code for f in kept] == ["locked-call-unlocked"]
        assert [f.code for f in suppressed] == ["unguarded-mutation"]

    def test_clean_code_no_findings(self, tmp_path):
        kept, _ = lint(tmp_path, CLEAN_LOCKED_SRC, LockDisciplineChecker())
        assert kept == []


# ---------------------------------------------------------------------------
# exception-hygiene
# ---------------------------------------------------------------------------

EXC_SRC = """\
def swallow():
    try:
        return 1
    except Exception:                         # line 4: silent swallow
        return None


def reraise_ok():
    try:
        return 1
    except Exception:
        raise


def logged_ok(log):
    try:
        return 1
    except Exception as e:
        log.warning("failed: %s", e)
        return None


def narrow_ok():
    try:
        return 1
    except ValueError:
        return None


def bare():
    try:
        return 1
    except:                                   # line 33: bare swallow
        pass
"""


class TestExceptionHygiene:
    def test_planted_violation_exact_location(self, tmp_path):
        kept, _ = lint(tmp_path, EXC_SRC, ExceptionHygieneChecker())
        assert locations(kept) == [
            ("exception-hygiene", "silent-swallow", "mod.py", 4),
            ("exception-hygiene", "silent-swallow", "mod.py", 33)]

    def test_suppression_is_the_justification(self, tmp_path):
        src = EXC_SRC.replace(
            "# line 4: silent swallow",
            "# capslint: disable=exception-hygiene — probe").replace(
            "# line 33: bare swallow", "# capslint: disable=all")
        kept, suppressed = lint(tmp_path, src, ExceptionHygieneChecker())
        assert kept == []
        assert len(suppressed) == 2

    def test_disagg_failover_keeps_its_justification(self):
        """The decode engine's failover handler takes any failure (the
        never-dropped invariant), as in the reference, with the
        reference's written justification above it."""
        text = (PORT_SRC / "serving" / "disagg.py").read_text().splitlines()
        i = next(n for n, ln in enumerate(text)
                 if ln.strip() == "except Exception:"
                 and "_undedup_pages" in text[n + 1])
        assert text[i - 1].strip() == \
            "# capslint: disable=exception-hygiene"


# ---------------------------------------------------------------------------
# parity with the reference's rules on the same planted sources
# ---------------------------------------------------------------------------

class TestParityWithReference:
    @pytest.mark.parametrize("source,checkers", [
        (LOCKED_SRC, (LockDisciplineChecker, RefLockDiscipline)),
        (POOL_SRC, (LockDisciplineChecker, RefLockDiscipline)),
        (CLEAN_LOCKED_SRC, (LockDisciplineChecker, RefLockDiscipline)),
        (EXC_SRC, (ExceptionHygieneChecker, RefExceptionHygiene)),
    ], ids=["locked", "pool", "clean", "exceptions"])
    def test_same_findings(self, tmp_path, source, checkers):
        port_cls, ref_cls = checkers
        ours, ours_sup = lint(tmp_path, source, port_cls())
        theirs, theirs_sup = lint(tmp_path, source, ref_cls(),
                                  project_cls=RefProject)
        assert records(ours) == records(theirs)
        assert records(ours_sup) == records(theirs_sup)
        assert port_cls.codes == ref_cls.codes

    def test_fingerprints_match(self):
        kw = dict(rule="lock-discipline", code="unguarded-mutation",
                  path="a.py", line=10, message="field `_q` mutated",
                  symbol="Engine.submit")
        assert Finding(**kw).fingerprint() == RefFinding(**kw).fingerprint()
        assert Finding(**kw).render() == RefFinding(**kw).render()


# ---------------------------------------------------------------------------
# graph-purity
# ---------------------------------------------------------------------------

PURITY_SRC = """\
import random
import time

import numpy as np
import torch


def bad_branch(x: torch.Tensor, flag: bool):
    if x.sum() > 0:                           # line 9: host branch
        return x
    if flag:                                  # host argument: clean
        return -x
    return x


def bad_cast(x):
    n = int(x.sum())                          # line 17: host sync
    return x.item() + n                       # line 18: host sync


def helper(x):
    a = x.cpu()                               # line 22: host sync
    b = x.tolist()                            # line 23: host sync
    c = x.numpy()                             # line 24: host sync
    return a, b, c, random.random()           # line 25: impure


def calls_helper(x, tables=None):
    if tables is not None:                    # identity: clean
        x = x + tables
    if x.shape[0] > 1 and x.dim() == 2:       # metadata: clean
        x = x * 2
    return helper(x), time.time(), np.random.rand()   # line 33: impure


def eager(x):
    if x.sum() > 0:                           # not a root: clean
        return time.time()
    return int(x)
"""

CLOSURE_SRC = """\
import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats = {}              # guarded-by: _lock

    def tick(self, x):
        return x + len(self._stats)   # line 10: stale closure
"""

PLANTED_ROOTS = (
    Root("ref.py:1 bad_branch", ("mod:bad_branch",)),
    Root("ref.py:2 bad_cast", ("mod:bad_cast",)),
    Root("ref.py:3 calls_helper", ("mod:calls_helper",)),
)


class TestGraphPurity:
    def test_planted_violations_exact_location(self, tmp_path):
        kept, _ = lint(tmp_path, PURITY_SRC, GraphPurityChecker(
            PLANTED_ROOTS))
        assert sorted(locations(kept)) == sorted([
            ("graph-purity", "host-branch", "mod.py", 9),
            ("graph-purity", "host-sync", "mod.py", 17),
            ("graph-purity", "host-sync", "mod.py", 18),
            ("graph-purity", "host-sync", "mod.py", 22),
            ("graph-purity", "host-sync", "mod.py", 23),
            ("graph-purity", "host-sync", "mod.py", 24),
            ("graph-purity", "impure-call", "mod.py", 25),
            ("graph-purity", "impure-call", "mod.py", 33)])
        # time.time() and np.random.rand() on one line: one finding a
        # (code, line), as the reference reports

    def test_mutable_closure(self, tmp_path):
        kept, _ = lint(tmp_path, CLOSURE_SRC, GraphPurityChecker(
            (Root("ref.py:1 tick", ("mod:Engine.tick",)),)))
        assert locations(kept) == [
            ("graph-purity", "mutable-closure", "mod.py", 10)]

    def test_suppression(self, tmp_path):
        src = PURITY_SRC.replace("# line 9: host branch",
                                 "# capslint: disable=graph-purity")
        kept, suppressed = lint(tmp_path, src, GraphPurityChecker(
            PLANTED_ROOTS))
        assert "host-branch" not in [f.code for f in kept]
        assert [f.code for f in suppressed] == ["host-branch"]

    def test_unrooted_code_not_policed(self, tmp_path):
        kept, _ = lint(tmp_path, PURITY_SRC, GraphPurityChecker(()))
        assert kept == []

    def test_missing_root(self, tmp_path):
        kept, _ = lint(tmp_path, PURITY_SRC, GraphPurityChecker(
            (Root("ref.py:1 gone", ("mod:gone", "mod:bad_cast")),)))
        assert ("graph-purity", "missing-root", "mod.py", 1) \
            in locations(kept)
        assert "host-sync" in [f.code for f in kept]   # the row's other target

    def test_missing_module_needs_the_whole_package(self, tmp_path):
        (tmp_path / "pkg").mkdir()
        (tmp_path / "pkg" / "__init__.py").write_text("")
        project = Project.load([tmp_path], root=tmp_path)
        roots = (Root("ref.py:1 f", ("pkg.gone:f",)),
                 Root("ref.py:2 g", ("other.gone:g",)))
        kept = list(GraphPurityChecker(roots).run(project))
        assert locations(kept) == [
            ("graph-purity", "missing-root", "pkg/__init__.py", 1)]

    def test_missing_cuda_kernel(self):
        project = Project.load([PORT_SRC], root=REPO)
        roots = (Root("ref.py:1 k", ("csrc/routing.cu:no_such_kernel",
                                     "csrc/gone.cu:kernel",
                                     "csrc/routing.cu:fused_routing_kernel")),)
        kept = list(GraphPurityChecker(roots).run(project))
        assert sorted(locations(kept)) == [
            ("graph-purity", "missing-root", "src/repro_torch/__init__.py",
             1),
            ("graph-purity", "missing-root",
             "src/repro_torch/csrc/routing.cu", 1)]


class TestRootTable:
    """The fixed root table against the reference's own root finder."""

    def test_covers_every_reference_root(self):
        project = RefProject.load([REPO / "src" / "repro"], root=REPO)
        found = sorted(f"{m.relpath}:{r.fn.node.lineno} {r.fn.symbol}"
                       for m in project.modules.values()
                       for r in ref_find_roots(m))
        assert len(found) == 24
        assert sorted(r.reference for r in purity.ROOTS) == found

    def test_every_row_resolves(self):
        project = Project.load([PORT_SRC], root=REPO)
        python, cuda = 0, 0
        for row in purity.ROOTS:
            assert row.targets
            for target in row.targets:
                fn, missing = purity._resolve_target(project, target)
                assert missing is None, missing.render()
                if target.startswith("csrc/"):
                    cuda += 1
                else:
                    assert fn is not None, target
                    python += 1
        # the seven registry wrappers and nine deploy, engine, model and
        # training functions, and the seven captured ones (the forward's
        # body, the staged decode tick under both engine rows, sampling's
        # device half, the staged prefill, paged prefill and inject
        # bodies); the nine Pallas bodies name 13 CUDA kernels
        assert python == 23 and cuda == 13

    def test_no_root_markers_in_the_port(self):
        """The roots live in the table only: no decorator, marker or hook
        names a root in the port's code."""
        for path in PORT_SRC.rglob("*.py"):
            if "analysis" in path.parts:
                continue
            text = path.read_text()
            assert "graph_root" not in text and "capture_root" not in text

    def test_real_tree_findings_are_the_baseline(self):
        """On the committed tree the rule finds exactly the baselined
        sites, each a graph-purity finding."""
        project = Project.load([PORT_SRC], root=REPO)
        kept, _ = apply_suppressions(
            project, list(GraphPurityChecker().run(project)))
        baseline = Baseline.load(REPO / "tools" /
                                 "capslint_torch_baseline.json")
        new, accepted, stale = baseline.split(kept)
        assert new == [] and stale == []
        assert {e["rule"] for e in baseline.entries.values()} \
            <= {"graph-purity"}
        assert len(accepted) == len(baseline.entries)


# ---------------------------------------------------------------------------
# kernel-legality
# ---------------------------------------------------------------------------

PLANTED_KERNEL_SRC = """\
import torch

from repro_torch.kernels.registry import KernelRegistry, KernelSpec


def make_example(case, device="cpu"):
    return (torch.zeros(case["shape"], device=device),), {}


def keep(config, x, **kwargs):
    return config


def plan_of(smem=0, threads=None, cluster=1):
    def launch_plan(config, x, **kwargs):
        return {"smem_bytes": smem,
                "threads": config["threads"] if threads is None else threads,
                "cluster": cluster}
    return launch_plan


def build_registry(legalize=keep, plan=plan_of(), base=None):
    reg = KernelRegistry()
    reg.register(KernelSpec(
        name="planted",
        build=lambda: None,
        reference=lambda: None,
        space={"threads": (64, 128), "page": (8, 12), "blk": (8, 64)},
        tuned=("threads",),
        base_config=base or {"threads": 128, "page": 8, "blk": 64},
        legalize=legalize,
        launch_plan=plan,
        make_example=make_example,
        example_cases=({"shape": (4, 8)},),
    ))
    return reg
"""


@pytest.fixture
def planted(tmp_path):
    """The planted registry lives in a compiled temp module so the
    checker's ``__code__``-derived file:line points inside tmp_path."""
    path = tmp_path / "planted.py"
    path.write_text(PLANTED_KERNEL_SRC)
    ns = {}
    exec(compile(PLANTED_KERNEL_SRC, str(path), "exec"), ns)
    project = Project.load([tmp_path], root=tmp_path)

    def run(**kw):
        return list(KernelLegalityChecker(ns["build_registry"](**kw))
                    .run(project))

    return ns, run


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    """One run of the rule over the port's real registry: its findings and
    the cases it proved each spec on."""
    root = tmp_path_factory.mktemp("legality")
    checker = KernelLegalityChecker()
    found = list(checker.run(Project.load([root], root=root)))
    return found, checker.cases


class TestKernelLegality:
    def test_real_registry_is_clean(self, real_run):
        found, _ = real_run
        assert found == [], [f.render() for f in found]

    @pytest.mark.parametrize("name", kernel_registry.names())
    def test_each_spec_proven_at_serving_shapes(self, real_run, name):
        """Every example case is proven, and so is at least one of its
        variants scaled to the shape buckets: a legalizer that refused
        every serving-sized shape would fail here."""
        _, cases = real_run
        spec = kernel_registry.get(name)
        assert cases[name]["example"] == len(spec.example_cases)
        assert cases[name]["scaled"] >= 1
        assert cases[name]["scaled"] >= cases[name]["refused"]

    @pytest.mark.parametrize("plan,code", [
        (dict(smem=limits.MAX_DYNAMIC_SMEM + 1), "over-smem"),
        (dict(threads=100), "bad-threads"),
        (dict(threads=1056), "bad-threads"),
        (dict(cluster=16), "over-cluster"),
    ], ids=["smem-232449", "threads-100", "threads-1056", "cluster-16"])
    def test_each_limit_flagged_at_the_plan(self, planted, plan, code):
        ns, run = planted
        found = run(plan=ns["plan_of"](**plan))
        assert {f.code for f in found} == {code}
        f = found[0]
        assert (f.rule, f.symbol, f.path) == ("kernel-legality", "planted",
                                              "planted.py")
        assert f.line == ns["plan_of"](**plan).__code__.co_firstlineno

    def test_limits_themselves_pass(self, planted):
        ns, run = planted
        assert run(plan=ns["plan_of"](smem=limits.MAX_DYNAMIC_SMEM,
                                      threads=1024, cluster=8)) == []

    def test_unstable_legalize(self, planted):
        ns, run = planted

        def drifting(config, x, **kwargs):
            config["threads"] = max(32, config["threads"] // 2)
            return config

        assert {f.code for f in run(legalize=drifting)} == {
            "unstable-legalize"}

    def test_plan_without_shared_memory(self, planted):
        """A kernel whose source fixes its shared memory (flash attention,
        the softmax tile) plans threads and cluster only."""
        ns, run = planted

        def plan(config, x, **kwargs):
            return {"threads": config["threads"], "cluster": 1}

        assert run(plan=plan) == []

    def test_illegal_config(self, planted):
        ns, run = planted
        found = run(base={"threads": 128, "page": 0, "blk": 64})
        assert {f.code for f in found} == {"illegal-config"}

    def test_legalize_failing_on_an_example(self, planted):
        ns, run = planted

        def broken(config, x, **kwargs):
            raise ValueError("no")

        found = run(legalize=broken)
        assert [f.code for f in found] == ["illegal-config"]

    def test_missing_launch_plan_is_warning(self, planted):
        ns, run = planted
        found = run(plan=None)
        assert [(f.code, f.severity) for f in found] == [
            ("unverifiable", "warning")]

    def test_every_spec_declares_a_plan(self):
        from repro_torch.kernels.registry import registry

        for name in registry.names():
            assert registry.get(name).launch_plan is not None, name

    def test_refused_scaled_shape_is_skipped(self):
        """An image of more capsules than a cluster's shared memory holds
        is refused outright (on meta as on the card), so the rule skips
        it, where the same shape as an example case is a finding."""
        from repro_torch.kernels.registry import registry

        spec = registry.get("fused_routing")
        u = torch.empty((2, 4096, 10, 16), device="meta")
        with pytest.raises(ValueError, match="shared memory"):
            spec.legalize(dict(spec.base_config), u)
        checker = KernelLegalityChecker()
        assert checker.prove(spec, (u,), {}, example=False) == []
        [(_, found)] = checker.prove(spec, (u,), {}, example=True)
        assert [f.code for f in found] == ["illegal-config"]


class TestOneHopperLimit:
    """The Python limits live in one module; the CUDA sources keep their
    own constants, held equal here."""

    @pytest.mark.parametrize("source,constant,value", [
        ("routing.cu", "kRoutingMaxSmem", limits.MAX_DYNAMIC_SMEM),
        ("decode_attention.cu", "kDecodeMaxSmem", limits.MAX_DYNAMIC_SMEM),
        ("sampling.cu", "kSampleMaxSmem", limits.MAX_DYNAMIC_SMEM),
        ("flash_attention.cu", "kFlashMaxSmem", limits.MAX_DYNAMIC_SMEM),
        ("softmax.cu", "kSoftmaxMaxSmem", limits.MAX_DYNAMIC_SMEM),
        ("routing.cu", "kRoutingMaxCluster", limits.MAX_CLUSTER),
        ("decode_attention.cu", "kDecodeMaxSplits", limits.MAX_CLUSTER),
        ("sampling.cu", "kSampleMaxCluster", limits.MAX_CLUSTER),
        ("flash_attention.cu", "kFlashThreads",
         attn_kernel.FLASH_THREADS["fma"]),
        ("flash_attention.cu", "kTcThreads",
         attn_kernel.FLASH_THREADS["tensor_core"]),
    ])
    def test_source_constant(self, source, constant, value):
        text = (PORT_SRC / "csrc" / source).read_text()
        m = re.search(rf"constexpr int {constant} = (\d+);", text)
        assert m and int(m.group(1)) == value

    def test_written_once_in_python(self):
        hits = [p.relative_to(PORT_SRC).as_posix()
                for p in PORT_SRC.rglob("*.py")
                if re.search(r"\b232448\b", p.read_text())]
        assert hits == ["kernels/limits.py"]

    def test_wrappers_take_the_limits(self):
        for mod in (routing_kernel, attn_kernel, sampling_kernel):
            assert mod.MAX_DYNAMIC_SMEM is limits.MAX_DYNAMIC_SMEM
        assert routing_kernel.ROUTING_MAX_CLUSTER == limits.MAX_CLUSTER
        assert sampling_kernel.SAMPLE_MAX_CLUSTER == limits.MAX_CLUSTER
        assert attn_kernel.DECODE_MAX_SPLITS == limits.MAX_CLUSTER

    @pytest.mark.parametrize("body,launch", [
        ("fma", "launch_flash_fma"), ("tensor_core", "launch_flash_tc")])
    def test_flash_shared_memory_fits(self, body, launch):
        """A flash block's shared memory is fixed by its head dim, so the
        source proves it fits in each launch template, which every head
        dim the dispatch takes instantiates."""
        text = (PORT_SRC / "csrc" / "flash_attention.cu").read_text()
        body_text = text[text.index(f"int {launch}("):]
        body_text = body_text[:body_text.index("<<<")]
        assert "static_assert(smem <= kFlashMaxSmem," in body_text

    def test_softmax_tile_fits(self):
        text = (PORT_SRC / "csrc" / "softmax.cu").read_text()
        assert ("static_assert(kSoftmaxTileBytes <= kSoftmaxMaxSmem,"
                in text)
        assert text.count("> kSoftmaxTileBytes)") == 2   # both tile launches


# ---------------------------------------------------------------------------
# findings / suppressions / baseline plumbing
# ---------------------------------------------------------------------------

def mk(rule="lock-discipline", code="unguarded-mutation", path="a.py",
       line=10, message="field `_q` mutated", symbol="Engine.submit",
       severity="error"):
    return Finding(rule=rule, code=code, path=path, line=line,
                   message=message, symbol=symbol, severity=severity)


class TestFindingsAndBaseline:
    def test_fingerprint_ignores_line(self):
        assert mk(line=10).fingerprint() == mk(line=99).fingerprint()
        assert mk().fingerprint() != mk(code="locked-call-unlocked"
                                        ).fingerprint()

    def test_sort_severity_then_location(self):
        fs = [mk(path="b.py", severity="warning"), mk(path="b.py"),
              mk(path="a.py", line=20), mk(path="a.py", line=5)]
        assert [(f.severity, f.path, f.line) for f in sort_findings(fs)] \
            == [("error", "a.py", 5), ("error", "a.py", 20),
                ("error", "b.py", 10), ("warning", "b.py", 10)]

    def test_baseline_round_trip_and_stale(self, tmp_path):
        path = tmp_path / "baseline.json"
        Baseline.load(path).save(path, [mk(), mk(path="gone.py")])
        new, accepted, stale = Baseline.load(path).split(
            [mk(line=42), mk(path="c.py")])
        assert [f.path for f in accepted] == ["a.py"]
        assert [f.path for f in new] == ["c.py"]
        assert [e["path"] for e in stale] == ["gone.py"]

    def test_baseline_file_readable_by_the_reference(self, tmp_path):
        """Both packages write the same baseline format."""
        path = tmp_path / "baseline.json"
        Baseline.load(path).save(path, [mk()])
        assert set(RefBaseline.load(path).entries) == {mk().fingerprint()}

    def test_version_mismatch_raises(self, tmp_path):
        path = tmp_path / "baseline.json"
        path.write_text(json.dumps({"version": 99, "findings": []}))
        with pytest.raises(ValueError, match="version"):
            Baseline.load(path)

    def test_filter_changed(self):
        fs = [mk(path="a.py"), mk(path="b.py"), mk(path="c/d.py")]
        assert [f.path for f in filter_changed(fs, ["b.py", "c/d.py"])] \
            == ["b.py", "c/d.py"]

    def test_module_names(self):
        project = Project.load([PORT_SRC / "serving"], root=REPO)
        assert "repro_torch.serving.core" in project.modules
        assert "repro_torch.serving" in project.modules


# ---------------------------------------------------------------------------
# the registry protocol and the gate on the real tree
# ---------------------------------------------------------------------------

class TestRegistryAndGate:
    def test_default_registry_names(self):
        assert default_registry().names() == [
            "exception-hygiene", "graph-purity", "kernel-legality",
            "lock-discipline"]

    def test_unknown_checker_raises(self):
        with pytest.raises(ValueError, match="unknown checker"):
            default_registry().get("jit-purity")

    def test_strict_json_clean_without_jax(self, tmp_path):
        """The gate passes on the committed tree, scans the whole port,
        and loads neither jax nor the reference package."""
        out = tmp_path / "findings.json"
        code = ("import sys; from repro_torch.analysis.__main__ import main; "
                f"rc = main(['--strict', '--json', {str(out)!r}]); "
                "bad = [m for m in ('jax', 'repro') if m in sys.modules]; "
                "print('LOADED', bad); sys.exit(rc or bool(bad))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, env=ENV)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "LOADED []" in proc.stdout
        payload = json.loads(out.read_text())
        assert payload["ok"] is True
        assert payload["counts"]["errors"] == 0
        assert payload["counts"]["stale_baseline"] == 0
        assert payload["counts"]["modules"] >= 80
        cases = payload["kernel_legality_cases"]
        assert set(cases) == set(kernel_registry.names())
        assert all(c["scaled"] >= 1 for c in cases.values()), cases

    def test_baseline_holds_graph_purity_only(self):
        """The baseline only shrinks: whatever it still accepts is a
        graph-purity finding, and lm.scatter_cache_rows' host read of its
        slot indices (its last entry) is gone from it."""
        blob = json.loads((REPO / "tools" /
                           "capslint_torch_baseline.json").read_text())
        assert {e["rule"] for e in blob["findings"]} <= {"graph-purity"}
        assert not any(e["symbol"] == "scatter_cache_rows"
                       for e in blob["findings"])

    def test_list_catalogue(self):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--list"],
            cwd=REPO, capture_output=True, text=True, env=ENV)
        assert proc.returncode == 0
        for rule in ("lock-discipline", "graph-purity", "kernel-legality",
                     "exception-hygiene"):
            assert f"{rule}:" in proc.stdout

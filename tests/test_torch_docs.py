"""The port's docs check: ``tools/check_docs_torch.py`` must pass (every
``repro_torch.*`` name in the five ``docs/torch_*.md`` resolves, the module
map names every sub-package, every test and ``chip_smoke.py`` phase a
contract table cites exists, and neither ``jax`` nor ``repro`` is
imported).  It runs in a subprocess, so this process's imports cannot hide
a missing module."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_check():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_docs_torch.py")],
        env=env, capture_output=True, text=True, timeout=600)


def test_check_docs_torch_passes():
    r = run_check()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[check_docs_torch] OK" in r.stdout


def load_check():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import check_docs_torch as cdt
    finally:
        sys.path.pop(0)
    return cdt


def test_a_broken_reference_is_reported(tmp_path, monkeypatch):
    cdt = load_check()
    doc = tmp_path / "doc.md"
    doc.write_text("`repro_torch.kernels.limits.MAX_CLUSTER` and "
                   "`repro_torch.kernels.no_such_module`\n")
    monkeypatch.setattr(cdt, "DOC_FILES", [doc])
    monkeypatch.setattr(cdt, "REPO", tmp_path)
    failures = cdt.check_module_refs()
    assert len(failures) == 1 and "no_such_module" in failures[0]


def test_every_port_doc_is_checked():
    cdt = load_check()
    docs = sorted((REPO / "docs").glob("torch_*.md"))
    assert len(docs) == 5
    assert sorted(cdt.DOC_FILES) == docs


def test_a_cited_test_that_does_not_exist_is_reported(tmp_path, monkeypatch):
    cdt = load_check()
    doc = tmp_path / "doc.md"
    doc.write_text(
        "| a | `tests/test_torch_contracts.py::test_paged_alias_invariance` |\n"
        "| b | `tests/test_torch_contracts.py::test_no_such_contract` |\n"
        "| c | `tests/test_torch_nowhere.py::test_x` |\n"
        "| d | `tests/test_torch_attention.py::TestLegalize::test_nope` |\n"
        "| e | `tests/test_torch_attention.py::TestLegalize::"
        "test_default_configs` |\n")
    monkeypatch.setattr(cdt, "DOC_FILES", [doc])
    failures = cdt.check_cited_tests()
    assert len(failures) == 3, failures
    assert any("test_no_such_contract" in f for f in failures)
    assert any("test_torch_nowhere" in f and "no such test file" in f
               for f in failures)
    assert any("test_nope" in f for f in failures)


def test_a_cited_phase_that_does_not_exist_is_reported(tmp_path,
                                                       monkeypatch):
    cdt = load_check()
    phases = cdt.script_phases()
    assert {"serve_lm", "serve_paged", "serve_disagg", "kernels",
            "timings", "done"} <= phases
    doc = tmp_path / "doc.md"
    doc.write_text("`chip_smoke.py::serve_lm` and `chip_smoke.py::serve_nowhere`\n")
    monkeypatch.setattr(cdt, "DOC_FILES", [doc])
    failures = cdt.check_cited_phases()
    assert len(failures) == 1 and "serve_nowhere" in failures[0]

"""The port's docs check: ``tools/check_docs_torch.py`` must pass (every
``repro_torch.*`` name in ``docs/torch_architecture.md`` and
``docs/torch_analysis.md`` resolves, the module map names every
sub-package, and neither ``jax`` nor ``repro`` is imported).  It runs in a
subprocess, so this process's imports cannot hide a missing module."""

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


def test_a_broken_reference_is_reported(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import check_docs_torch as cdt
    finally:
        sys.path.pop(0)
    doc = tmp_path / "doc.md"
    doc.write_text("`repro_torch.kernels.limits.MAX_CLUSTER` and "
                   "`repro_torch.kernels.no_such_module`\n")
    monkeypatch.setattr(cdt, "DOC_FILES", [doc])
    monkeypatch.setattr(cdt, "REPO", tmp_path)
    failures = cdt.check_module_refs()
    assert len(failures) == 1 and "no_such_module" in failures[0]

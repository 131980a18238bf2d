#!/usr/bin/env python
"""Docs check of the PyTorch/CUDA port (run by tests/test_torch_docs.py).

Four guarantees, so the port's docs cannot silently rot:

1. every backticked dotted ``repro_torch.*`` reference in the port's docs
   (``docs/torch_*.md``: the architecture, capslint, kernels, serving and
   traffic docs) resolves: importable as a module, or an attribute of its
   importable parent;
2. the module map in ``docs/torch_architecture.md`` names every top-level
   module and sub-package of ``src/repro_torch``;
3. every test a doc cites as ``tests/test_torch_<name>.py::<test>`` (or
   ``::<Class>::<test>``) names a test function or class of that file;
4. every ``chip_smoke.py`` phase a doc cites as ``chip_smoke.py::<phase>``
   is a phase the script times or emits a line for.

It imports the port only, never ``jax`` or the reference package, and
fails if either was loaded; the test files and the script are parsed, not
imported.  Usage, from the repo root:
``PYTHONPATH=src python tools/check_docs_torch.py``.  Exits non-zero
listing every failure.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ARCHITECTURE = REPO / "docs" / "torch_architecture.md"
DOC_FILES = [ARCHITECTURE] + [REPO / "docs" / f"torch_{name}.md" for name in
                              ("analysis", "kernels", "serving", "traffic")]
PACKAGE = REPO / "src" / "repro_torch"
SCRIPT = REPO / "chip_smoke.py"

_REF_RE = re.compile(r"`(repro_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+)`")
_TEST_RE = re.compile(r"`(tests/test_torch_\w+\.py)::(\w+)(?:::(\w+))?`")
_PHASE_RE = re.compile(r"`chip_smoke\.py::(\w+)`")


def _resolves(ref: str) -> bool:
    try:
        if importlib.util.find_spec(ref) is not None:
            return True
    except ModuleNotFoundError:
        pass
    parent, _, attr = ref.rpartition(".")
    try:
        return hasattr(importlib.import_module(parent), attr)
    except ImportError:
        return False


def _name(doc: Path):
    return doc.relative_to(REPO) if doc.is_relative_to(REPO) else doc


def _docs():
    for doc in DOC_FILES:
        if doc.exists():
            yield doc, doc.read_text()


def _missing_docs() -> list:
    return [f"{_name(doc)}: file missing"
            for doc in DOC_FILES if not doc.exists()]


def check_module_refs() -> list:
    failures = _missing_docs()
    for doc, text in _docs():
        for ref in sorted(set(_REF_RE.findall(text))):
            if not _resolves(ref):
                failures.append(f"{_name(doc)}: `{ref}` does not "
                                f"resolve to a module or module attribute")
    return failures


def check_module_map() -> list:
    """Every ``repro_torch.<name>`` (a top-level module or sub-package)
    appears in the architecture doc."""
    text = ARCHITECTURE.read_text() if ARCHITECTURE.exists() else ""
    names = sorted(p.stem if p.is_file() else p.name
                   for p in PACKAGE.iterdir()
                   if (p.suffix == ".py" and p.stem != "__init__")
                   or (p / "__init__.py").exists())
    return [f"{ARCHITECTURE.relative_to(REPO)}: the module map does not "
            f"name `repro_torch.{n}`"
            for n in names if f"`repro_torch.{n}" not in text]


def _test_names(path: Path) -> dict:
    """Top-level test functions and classes of a test file, each class with
    the names of its methods."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = set()
        elif isinstance(node, ast.ClassDef):
            out[node.name] = {n.name for n in node.body
                              if isinstance(n, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))}
    return out


def check_cited_tests() -> list:
    failures, parsed = [], {}
    for doc, text in _docs():
        for path, name, method in sorted(set(_TEST_RE.findall(text))):
            where = f"{_name(doc)}: `{path}::{name}"
            if path not in parsed:
                file = REPO / path
                parsed[path] = _test_names(file) if file.exists() else None
            names = parsed[path]
            if names is None:
                failures.append(f"{where}`: no such test file")
            elif name not in names:
                failures.append(f"{where}`: no such test function or class")
            elif method and method not in names[name]:
                failures.append(f"{where}::{method}`: no such test method")
    return failures


def script_phases(script: Path = SCRIPT) -> set:
    """The phases ``chip_smoke.py`` times (``timed("<phase>", ...)``) or
    emits a line for (``emit("<phase>", ...)``), read from its source."""
    phases = set()
    for node in ast.walk(ast.parse(script.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("timed", "emit") and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            phases.add(node.args[0].value)
    return phases


def check_cited_phases() -> list:
    phases = script_phases() if SCRIPT.exists() else set()
    return [f"{_name(doc)}: `chip_smoke.py::{p}` is not a phase "
            f"of the script"
            for doc, text in _docs()
            for p in sorted(set(_PHASE_RE.findall(text)))
            if p not in phases]


def main() -> int:
    failures = (check_module_refs() + check_module_map()
                + check_cited_tests() + check_cited_phases())
    loaded = [m for m in ("jax", "repro") if m in sys.modules]
    if loaded:
        failures.append(f"the port's docs check loaded {loaded}")
    print(f"[check_docs_torch] "
          f"{'OK' if not failures else f'{len(failures)} failure(s)'}")
    for f in failures:
        print(f"  FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

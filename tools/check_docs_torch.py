#!/usr/bin/env python
"""Docs check of the PyTorch/CUDA port (run by tests/test_torch_docs.py).

Two guarantees, so the port's docs cannot silently rot:

1. every backticked dotted ``repro_torch.*`` reference in
   ``docs/torch_architecture.md`` and ``docs/torch_analysis.md`` resolves:
   importable as a module, or an attribute of its importable parent;
2. the module map in ``docs/torch_architecture.md`` names every top-level
   module and sub-package of ``src/repro_torch``.

It imports the port only, never ``jax`` or the reference package, and
fails if either was loaded.  Usage, from the repo root:
``PYTHONPATH=src python tools/check_docs_torch.py``.  Exits non-zero
listing every failure.
"""

from __future__ import annotations

import importlib
import importlib.util
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ARCHITECTURE = REPO / "docs" / "torch_architecture.md"
DOC_FILES = [ARCHITECTURE, REPO / "docs" / "torch_analysis.md"]
PACKAGE = REPO / "src" / "repro_torch"

_REF_RE = re.compile(r"`(repro_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+)`")


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


def check_module_refs() -> list:
    failures = []
    for doc in DOC_FILES:
        if not doc.exists():
            failures.append(f"{doc.relative_to(REPO)}: file missing")
            continue
        for ref in sorted(set(_REF_RE.findall(doc.read_text()))):
            if not _resolves(ref):
                failures.append(f"{doc.relative_to(REPO)}: `{ref}` does not "
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


def main() -> int:
    failures = check_module_refs() + check_module_map()
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

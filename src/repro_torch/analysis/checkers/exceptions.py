"""exception-hygiene: no broad `except` that swallows errors silently.

``except Exception:`` has exactly three legitimate shapes in this
codebase:

1. it **re-raises** (possibly after cleanup or wrapping),
2. it **records** the failure (log / print / traceback) so the error is
   observable even though the process survives — the failover paths in
   ``repro_torch.serving.disagg`` are the canonical example, or
3. it carries a written justification: a ``# capslint:
   disable=exception-hygiene — <why>`` comment (the decode engine's
   redelivery in ``repro_torch.serving.disagg``, where *any* failure must
   bring the handoff back to the queue).

Everything else is a silent swallow: the error vanishes, the caller sees
a default, and the bug surfaces three layers away.  This checker flags
handlers whose type is bare, ``Exception``, or ``BaseException``
(including inside tuples) and whose body neither raises nor records.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.loader import Module, Project

BROAD = frozenset({"Exception", "BaseException"})
#: call names that make a swallow observable
LOG_NAME_CALLS = frozenset({"print"})
LOG_ATTR_CALLS = frozenset({
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "print_exc", "print_exception", "format_exc", "record",
})


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    exprs = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in exprs:
        name = e.id if isinstance(e, ast.Name) else (
            e.attr if isinstance(e, ast.Attribute) else None)
        if name in BROAD:
            return True
    return False


def _handles(handler: ast.ExceptHandler) -> bool:
    """True when the handler re-raises or records the failure."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) \
                    and node.func.id in LOG_NAME_CALLS:
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in LOG_ATTR_CALLS:
                return True
    return False


class ExceptionHygieneChecker:
    name = "exception-hygiene"
    description = ("`except Exception` / bare `except` must re-raise, "
                   "record the failure, or carry a `# capslint: disable` "
                   "justification")
    codes = {
        "silent-swallow": "broad handler neither re-raises nor records "
                          "the failure",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for module in project.modules.values():
            tree = module.tree
            for node, symbol in _walk_with_symbol(tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if _is_broad(node) and not _handles(node):
                    label = ("bare `except`" if node.type is None else
                             f"`except "
                             f"{ast.unparse(node.type)}`")
                    yield Finding(
                        rule=self.name, code="silent-swallow",
                        path=module.relpath, line=node.lineno,
                        symbol=symbol or "",
                        message=(f"{label} swallows the error without "
                                 f"re-raising or recording it"),
                        hint="narrow the exception type, log/re-raise, "
                             "or justify with `# capslint: "
                             "disable=exception-hygiene — <why>`")


def _walk_with_symbol(tree: ast.AST):
    """Yield ``(node, enclosing "Class.method" symbol)`` for every node."""

    def visit(node: ast.AST, cls: Optional[str], fn: Optional[str]):
        symbol = f"{cls}.{fn}" if cls and fn else (fn or cls)
        yield node, symbol
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name, None)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from visit(child, cls, child.name)
            else:
                yield from visit(child, cls, fn)

    yield from visit(tree, None, None)

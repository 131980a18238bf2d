"""lock-discipline: ``# guarded-by:`` annotated fields mutate under their lock.

The serving engines already follow a convention by hand: shared state
(queues, request tables, stats) is declared in ``__init__`` and only ever
mutated inside ``with self._lock:`` blocks or inside helper methods whose
``*_locked`` suffix documents "caller holds the lock"
(:meth:`repro_torch.serving.EngineCore._complete_locked` is the seed
example).  This checker turns the convention into a machine-checked contract:

* a field whose defining ``__init__`` assignment carries a
  ``# guarded-by: <lock>`` comment may be **mutated** (assigned, aug-
  assigned, ``del``-ed, or hit with a mutating container method such as
  ``append`` / ``pop`` / ``update``) only

    - lexically inside ``with self.<lock>:``, or
    - inside a method whose name ends in ``_locked``;

* a ``self.*_locked(...)`` call must itself sit inside a ``with
  self.<some lock>:`` block (or inside another ``*_locked`` method) — a
  ``*_locked`` helper reached from an unlocked public path is exactly the
  bug the suffix exists to prevent.

Known limits (by design — this is a convention checker, not an alias
analysis): mutations through a local alias (``st = self._stats;
st.ticks += 1``) and reads are not tracked, and ``with`` blocks re-entered
via nested ``def``\\ s reset to unlocked (the closure runs later, when the
lock is long released).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.loader import Module, Project

_GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

#: container/object methods that mutate their receiver in place
MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "add", "update", "setdefault", "sort", "reverse", "rotate",
})


def guarded_fields(module: Module) -> Dict[str, Dict[str, str]]:
    """``{class name: {field: lock}}`` from ``# guarded-by:`` comments on
    the ``self.<field> = ...`` lines of each class ``__init__``."""
    out: Dict[str, Dict[str, str]] = {}
    for cls in module.tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        fields: Dict[str, str] = {}
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                        continue
                    m = _GUARDED_RE.search(module.comments.get(
                        node.lineno, ""))
                    if not m:
                        continue
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        field = _self_field(t)
                        if field:
                            fields[field] = m.group(1)
        if fields:
            out[cls.name] = fields
    return out


def class_guarded_fields(project: Project, module: Module,
                         cls: ast.ClassDef) -> Dict[str, str]:
    """Guarded fields of ``cls`` including fields inherited from bases the
    project can resolve (same module, or imported ``from X import Base``)."""
    merged: Dict[str, str] = {}
    seen: Set[Tuple[str, str]] = set()

    def visit(mod: Module, cdef: ast.ClassDef) -> None:
        if (mod.name, cdef.name) in seen:
            return
        seen.add((mod.name, cdef.name))
        for base in cdef.bases:
            resolved = _resolve_base(project, mod, base)
            if resolved:
                visit(*resolved)
        merged.update(guarded_fields(mod).get(cdef.name, {}))

    visit(module, cls)
    return merged


def _resolve_base(project: Project, module: Module, base: ast.expr
                  ) -> Optional[Tuple[Module, ast.ClassDef]]:
    if isinstance(base, ast.Name):
        for node in module.tree.body:       # same module first
            if isinstance(node, ast.ClassDef) and node.name == base.id:
                return (module, node)
        target = project.resolve_import(module, base.id)
        if target and target[1] is not None:
            other = project.get(target[0])
            if other:
                for node in other.tree.body:
                    if isinstance(node, ast.ClassDef) \
                            and node.name == target[1]:
                        return (other, node)
    return None


def _self_field(node: ast.expr) -> Optional[str]:
    """The engine field a store/mutation target ultimately names:
    ``self.f`` -> f, ``self.f.g`` -> f, ``self.f[i]`` -> f."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        node = node.value
    return None


class LockDisciplineChecker:
    name = "lock-discipline"
    description = ("fields annotated `# guarded-by: <lock>` mutate only "
                   "under `with self.<lock>:` or in `*_locked` methods, "
                   "and `*_locked` methods are only called with a lock "
                   "held")
    codes = {
        "unguarded-mutation": "guarded field mutated without its lock",
        "locked-call-unlocked": "`*_locked` method called from an "
                                "unlocked path",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for module in project.modules.values():
            if not guarded_fields(module) and "_locked" not in module.source:
                continue              # fast path: nothing to police here
            for cls in module.tree.body:
                if isinstance(cls, ast.ClassDef):
                    yield from self._check_class(project, module, cls)

    # -- per-class ----------------------------------------------------------

    def _check_class(self, project: Project, module: Module,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        guarded = class_guarded_fields(project, module, cls)
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue              # defining assignments pre-date sharing
            yield from self._check_method(module, cls, fn, guarded)

    def _check_method(self, module: Module, cls: ast.ClassDef,
                      fn: ast.FunctionDef, guarded: Dict[str, str]
                      ) -> Iterator[Finding]:
        symbol = f"{cls.name}.{fn.name}"
        contract_locked = fn.name.endswith("_locked")

        def walk(node: ast.AST, held: Set[str]) -> Iterator[Finding]:
            if isinstance(node, ast.With):
                inner = held | set(self._with_locks(node))
                for item in node.items:
                    yield from walk(item.context_expr, held)
                for child in node.body:
                    yield from walk(child, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                # a nested def runs later, when the lock is released
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for child in body:
                    yield from walk(child, set())
                return
            yield from self._check_node(module, symbol, node, held,
                                        guarded, contract_locked)
            for child in ast.iter_child_nodes(node):
                yield from walk(child, held)

        for stmt in fn.body:
            yield from walk(stmt, set())

    @staticmethod
    def _with_locks(node: ast.With) -> List[str]:
        locks = []
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Attribute) \
                    and isinstance(ctx.value, ast.Name) \
                    and ctx.value.id == "self":
                locks.append(ctx.attr)
        return locks

    def _check_node(self, module: Module, symbol: str, node: ast.AST,
                    held: Set[str], guarded: Dict[str, str],
                    contract_locked: bool) -> Iterator[Finding]:
        # mutations: assignment / augmented assignment / del targets
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for t in targets:
            for leaf in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                         else [t]):
                field = _self_field(leaf)
                yield from self._mutation(module, symbol, node, field,
                                          held, guarded, contract_locked)
        # mutations: self.<field>.append(...) etc
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr in MUTATORS:
                field = _self_field(node.func.value)
                yield from self._mutation(module, symbol, node, field,
                                          held, guarded, contract_locked)
            # `self.*_locked()` calls need a lock held at the call site
            if node.func.attr.endswith("_locked") \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" \
                    and not contract_locked and not held:
                yield Finding(
                    rule=self.name, code="locked-call-unlocked",
                    path=module.relpath, line=node.lineno, symbol=symbol,
                    message=(f"`self.{node.func.attr}()` called without "
                             f"any `with self.<lock>:` held — the "
                             f"`_locked` suffix is a caller-holds-the-"
                             f"lock contract"),
                    hint="wrap the call in `with self._lock:` (or call "
                         "from another `*_locked` method)")

    def _mutation(self, module: Module, symbol: str, node: ast.AST,
                  field: Optional[str], held: Set[str],
                  guarded: Dict[str, str], contract_locked: bool
                  ) -> Iterator[Finding]:
        if field is None or field not in guarded:
            return
        lock = guarded[field]
        if lock in held or contract_locked:
            return
        yield Finding(
            rule=self.name, code="unguarded-mutation",
            path=module.relpath, line=node.lineno, symbol=symbol,
            message=(f"field `{field}` is `# guarded-by: {lock}` but is "
                     f"mutated outside `with self.{lock}:`"),
            hint=f"take `with self.{lock}:` around the mutation, or move "
                 f"it into a `*_locked` method whose callers hold the "
                 f"lock")

"""Shared AST / module-graph loader for the capslint checkers.

Every checker sees the same :class:`Project`: each ``.py`` file under the
scanned roots parsed exactly once into a :class:`Module` carrying its AST,
its comments (by line — the lock-discipline ``# guarded-by:`` annotations
and the ``# capslint: disable=`` suppressions both live in comments, which
``ast`` alone drops), and its dotted module name.  The loader also builds
the import map each module exposes (`lm` -> ``repro_torch.models.lm``),
which is what lets the graph-purity checker chase calls across module
boundaries without executing anything.

Nothing here imports the code under analysis — the loader is pure
``ast``/``tokenize`` — so the checkers can run on broken or
torch-unavailable trees.  (The kernel-legality checker is the one exception
and does its own runtime import of the kernel registry.)
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: ``# capslint: disable=rule-a,rule-b`` (or ``all``) — trailing on the
#: offending line or on the line directly above it.
_DISABLE_RE = re.compile(r"capslint:\s*disable=([A-Za-z0-9_.,\- ]+)")


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    name: str                         # dotted module name ("repro_torch.serving.core")
    path: Path                        # absolute file path
    relpath: str                      # path findings report (posix, repo-relative)
    source: str
    tree: ast.Module
    comments: Dict[int, str]          # line -> comment text (sans leading '#')
    _imports: Optional[Dict[str, Tuple[str, Optional[str]]]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    def disabled_rules(self, line: int) -> Set[str]:
        """Rule names suppressed at ``line`` (same line or the line above)."""
        out: Set[str] = set()
        for ln in (line, line - 1):
            m = _DISABLE_RE.search(self.comments.get(ln, ""))
            if m:
                out.update(tok.strip() for tok in m.group(1).split(",")
                           if tok.strip())
        return out

    # -- import map ---------------------------------------------------------

    def imports(self) -> Dict[str, Tuple[str, Optional[str]]]:
        """Local name -> ``(module, attr)``: what each imported name means.

        ``import repro_torch.models.lm as lm``  -> ``lm: ("repro_torch.models.lm", None)``
        ``from repro_torch.models import lm``   -> ``lm: ("repro_torch.models.lm", None)``
        ``from repro_torch.models.lm import decode_step``
                                                -> ``decode_step: ("repro_torch.models.lm", "decode_step")``

        ``from X import Y`` is ambiguous between submodule and attribute;
        callers disambiguate against the project's module table.  Built
        once per module (the checkers ask for it at every call they
        resolve).
        """
        if self._imports is not None:
            return self._imports
        out: Dict[str, Tuple[str, Optional[str]]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    out[local] = (target, None)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    out[local] = (node.module, alias.name)
        self._imports = out
        return out


class Project:
    """Every scanned module, plus the cross-module lookups checkers share."""

    def __init__(self, modules: List[Module], root: Path):
        self.root = root
        self.modules: Dict[str, Module] = {m.name: m for m in modules}
        self._by_relpath = {m.relpath: m for m in modules}

    # -- construction --------------------------------------------------------

    @classmethod
    def load(cls, paths: Iterable[Path], root: Optional[Path] = None
             ) -> "Project":
        """Parse every ``.py`` file under ``paths`` (files or directories).

        ``root`` anchors the repo-relative paths findings report; it
        defaults to the common parent that makes ``src/...`` visible (the
        directory two levels above a ``src/<pkg>`` scan root) or the
        parent of the first path.
        """
        files: List[Path] = []
        for p in paths:
            p = Path(p).resolve()
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                files.append(p)
        if root is None:
            root = _infer_root(files)
        root = Path(root).resolve()
        modules = [m for m in (_parse(f, root) for f in files)
                   if m is not None]
        return cls(modules, root)

    # -- lookups -------------------------------------------------------------

    def module_for_path(self, path: Path) -> Optional[Module]:
        try:
            rel = Path(path).resolve().relative_to(self.root).as_posix()
        except ValueError:
            return None
        return self._by_relpath.get(rel)

    def relpath(self, path) -> str:
        """Repo-relative posix path for reporting (falls back to the
        original string for files outside the root)."""
        try:
            return Path(path).resolve().relative_to(self.root).as_posix()
        except ValueError:
            return str(path)

    def get(self, modname: str) -> Optional[Module]:
        return self.modules.get(modname)

    def resolve_import(self, module: Module, local: str
                       ) -> Optional[Tuple[str, Optional[str]]]:
        """What imported name ``local`` refers to, normalized against the
        project's module table: returns ``(modname, attr_or_None)`` with
        ``from X import Y`` resolved to the submodule ``X.Y`` when that
        submodule was scanned."""
        target = module.imports().get(local)
        if target is None:
            return None
        modname, attr = target
        if attr is not None and f"{modname}.{attr}" in self.modules:
            return (f"{modname}.{attr}", None)
        return (modname, attr)


def _infer_root(files: List[Path]) -> Path:
    for f in files:
        for parent in f.parents:
            if parent.name == "src" and (parent / "repro_torch").exists():
                return parent.parent
    return files[0].parent if files else Path.cwd()


def _parse(path: Path, root: Path) -> Optional[Module]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError):
        return None                   # unreadable/unparsable: not ours to lint
    try:
        rel = path.relative_to(root).as_posix()
    except ValueError:
        rel = str(path)
    return Module(name=_module_name(path), path=path, relpath=rel,
                  source=source, tree=tree, comments=_comments(source))


def _module_name(path: Path) -> str:
    """Dotted module name by walking up through ``__init__.py`` packages
    (``src/repro_torch/serving/core.py`` -> ``repro_torch.serving.core``:
    ``repro_torch`` is a regular package, so it needs none of the extra
    hop the reference's loader takes for its namespace package)."""
    parts = [path.stem] if path.stem != "__init__" else []
    parent = path.parent
    while (parent / "__init__.py").exists():
        parts.insert(0, parent.name)
        parent = parent.parent
    return ".".join(parts) or path.stem


def _comments(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:
        pass                          # partial comment map beats crashing
    return out

"""Checker protocol + registry: typed dispatch for the capslint rules.

This mirrors the :class:`repro_torch.kernels.KernelRegistry` idiom one layer
up:
one typed spec per checker (name, description, sub-rule catalogue, run
callable), a registry that resolves names with a helpful error, and a
``run()`` that fans a shared :class:`repro_torch.analysis.loader.Project` out to
every selected checker and returns the merged, canonically-sorted finding
list.  Checkers are constructed lazily at registration time but hold no
mutable state across runs — ``run(project)`` must be a pure function of
the project (plus, for kernel-legality, the kernel registry it verifies).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Protocol, Mapping, \
    runtime_checkable

from repro_torch.analysis.findings import Finding, sort_findings
from repro_torch.analysis.loader import Project


@runtime_checkable
class Checker(Protocol):
    """What every capslint rule implements."""

    #: rule id findings carry and suppressions name (kebab-case)
    name: str
    #: one-line rule description (the ``--list`` catalogue)
    description: str
    #: sub-rule code -> one-line description
    codes: Mapping[str, str]

    def run(self, project: Project) -> Iterable[Finding]:
        ...


class CheckerRegistry:
    """Name -> :class:`Checker`; resolution + fan-out."""

    def __init__(self):
        self._checkers: Dict[str, Checker] = {}

    def register(self, checker: Checker) -> Checker:
        self._checkers[checker.name] = checker
        return checker

    def names(self) -> List[str]:
        return sorted(self._checkers)

    def get(self, name: str) -> Checker:
        try:
            return self._checkers[name]
        except KeyError:
            raise ValueError(f"unknown checker {name!r}; registered: "
                             f"{self.names()}") from None

    def run(self, project: Project,
            select: Optional[Iterable[str]] = None) -> List[Finding]:
        """Run the selected checkers (all by default) over one project."""
        names = list(select) if select is not None else self.names()
        out: List[Finding] = []
        for name in names:
            out.extend(self.get(name).run(project))
        return sort_findings(out)


registry = CheckerRegistry()
_populated = False


def default_registry() -> CheckerRegistry:
    """The process-wide registry with the four stock rules registered
    (lazy import: ``repro_torch.analysis`` stays importable without pulling
    the checker modules — or torch — until a run is requested)."""
    global _populated
    if not _populated:
        from repro_torch.analysis.checkers import (exceptions, legality, locks,
                                             purity)

        registry.register(locks.LockDisciplineChecker())
        registry.register(purity.GraphPurityChecker())
        registry.register(legality.KernelLegalityChecker())
        registry.register(exceptions.ExceptionHygieneChecker())
        _populated = True
    return registry

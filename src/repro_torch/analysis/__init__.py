"""capslint for the port: the static-analysis gate of ``repro_torch``
(``python -m repro_torch.analysis``).

The port keeps the reference's conventions that no general-purpose linter
knows about: shared engine state mutates under its annotated lock
(``# guarded-by:``), the code a captured CUDA graph replays stays free
of host syncs and frozen host reads, every tuner candidate a kernel's
``legalize`` can emit fits Hopper's launch limits, and broad ``except``
handlers never swallow errors silently.  This package turns those
conventions into machine-checked rules, as ``repro.analysis`` does for the
reference; it imports neither ``jax`` nor ``repro`` and keeps its own copy
of the loader, findings and registry code:

* :mod:`repro_torch.analysis.loader` — parses ``src/repro_torch`` once into
  a :class:`Project` of :class:`Module` ASTs + comment maps (shared by all
  checkers; nothing analyzed is executed, except the kernel-legality rule
  which evaluates the live registry's pure config and plan callables);
* :mod:`repro_torch.analysis.findings` — the :class:`Finding` record,
  ``# capslint: disable=<rule>`` inline suppressions, and the committed
  shrink-only :class:`Baseline`;
* :mod:`repro_torch.analysis.registry` — the :class:`Checker` protocol and
  :class:`CheckerRegistry`;
* :mod:`repro_torch.analysis.checkers` — the four stock rules:
  ``lock-discipline``, ``graph-purity``, ``kernel-legality``,
  ``exception-hygiene``;
* :mod:`repro_torch.analysis.__main__` — the CLI and gate (``--strict``
  fails on any non-baselined error finding and on stale baseline
  entries).

See ``docs/torch_analysis.md`` for the rule catalogue, the graph-purity
root table and the suppression / baseline workflow.
"""

from repro_torch.analysis.findings import (Baseline, Finding,
                                           apply_suppressions, sort_findings)
from repro_torch.analysis.loader import Module, Project
from repro_torch.analysis.registry import (Checker, CheckerRegistry,
                                           default_registry, registry)

__all__ = [
    "Baseline",
    "Checker",
    "CheckerRegistry",
    "Finding",
    "Module",
    "Project",
    "apply_suppressions",
    "default_registry",
    "registry",
    "sort_findings",
]

"""The port's capslint CLI / gate: ``python -m repro_torch.analysis``.

Default invocation scans the ``repro_torch`` package source, runs
every registered checker, applies inline ``# capslint: disable=``
suppressions and the committed baseline, prints the surviving findings
as a table (or ``--json``), and exits non-zero when a non-baselined
*error* finding remains.  ``--strict`` (the CI lane) additionally fails
on stale baseline entries, so the baseline can only ever shrink.

    python -m repro_torch.analysis                      # human table
    python -m repro_torch.analysis --json findings.json # CI artifact
    python -m repro_torch.analysis --strict             # the gate
    python -m repro_torch.analysis --changed-only       # diff vs HEAD only
    python -m repro_torch.analysis --select lock-discipline graph-purity
    python -m repro_torch.analysis --write-baseline     # accept current findings
    python -m repro_torch.analysis --list               # rule catalogue
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.findings import (Baseline, Finding, apply_suppressions,
                                     sort_findings)
from repro_torch.analysis.loader import Project
from repro_torch.analysis.registry import default_registry


def _package_dir() -> Path:
    # repro_torch is a regular package: src/repro_torch/analysis -> its root
    return Path(__file__).resolve().parent.parent


def _repo_root() -> Path:
    return _package_dir().parent.parent   # src/repro_torch -> src -> repo


def _default_scan_paths() -> List[Path]:
    return [_package_dir()]


def changed_files(root: Path, base: str = "HEAD") -> Optional[List[str]]:
    """Repo-relative paths changed vs ``base`` (staged + unstaged +
    untracked); ``None`` when git is unavailable (fail open: report
    everything rather than silently nothing)."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", base, "--"],
            cwd=root, capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if diff.returncode != 0:
        return None
    files = [ln.strip() for ln in diff.stdout.splitlines() if ln.strip()]
    if untracked.returncode == 0:
        files.extend(ln.strip() for ln in untracked.stdout.splitlines()
                     if ln.strip())
    return files


def filter_changed(findings: List[Finding], changed: List[str]
                   ) -> List[Finding]:
    allowed = set(changed)
    return [f for f in findings if f.path in allowed]


def _print_list() -> None:
    reg = default_registry()
    for name in reg.names():
        checker = reg.get(name)
        print(f"{name}: {checker.description}")
        for code in sorted(checker.codes):
            print(f"  {name}.{code}: {checker.codes[code]}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="capslint: the port's static-analysis gate")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/directories to scan "
                             "(default: the repro_torch package)")
    parser.add_argument("--json", nargs="?", const="-", metavar="FILE",
                        help="emit findings as JSON (to FILE, or stdout)")
    parser.add_argument("--strict", action="store_true",
                        help="CI gate: also fail on stale baseline entries")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="baseline file "
                             "(default: tools/capslint_torch_baseline.json)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept the current findings into the "
                             "baseline and exit 0")
    parser.add_argument("--changed-only", nargs="?", const="HEAD",
                        metavar="BASE",
                        help="only report findings in files changed vs "
                             "BASE (default HEAD)")
    parser.add_argument("--select", nargs="+", metavar="RULE",
                        help="run only these checkers")
    parser.add_argument("--list", action="store_true", dest="list_rules",
                        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        _print_list()
        return 0

    root = _repo_root()
    scan = [p.resolve() for p in args.paths] or _default_scan_paths()
    project = Project.load(scan, root=root)
    registry = default_registry()
    raw = registry.run(project, select=args.select)
    kept, suppressed = apply_suppressions(project, raw)

    baseline_path = args.baseline or (root / "tools" /
                                      "capslint_torch_baseline.json")
    if args.write_baseline:
        Baseline.load(baseline_path).save(baseline_path, kept)
        print(f"wrote {len(kept)} finding(s) to {baseline_path}")
        return 0

    baseline = Baseline.load(baseline_path)
    new, baselined, stale = baseline.split(kept)

    if args.changed_only is not None:
        changed = changed_files(root, args.changed_only)
        if changed is not None:
            new = filter_changed(new, changed)

    new = sort_findings(new)
    errors = [f for f in new if f.severity == "error"]
    warnings = [f for f in new if f.severity != "error"]
    gate_failed = bool(errors) or (args.strict and bool(stale))

    if args.json is not None:
        payload = {
            "version": 1,
            "findings": [f.to_dict() for f in new],
            "counts": {"new": len(new), "errors": len(errors),
                       "warnings": len(warnings),
                       "suppressed": len(suppressed),
                       "baselined": len(baselined),
                       "stale_baseline": len(stale),
                       "modules": len(project.modules)},
            "stale_baseline": stale,
            "ok": not gate_failed,
        }
        if "kernel-legality" in (args.select or registry.names()):
            # the cases each kernel spec was proven on (example, scaled to
            # the shape buckets, and scaled but refused by the kernel)
            payload["kernel_legality_cases"] = \
                registry.get("kernel-legality").cases
        blob = json.dumps(payload, indent=1, sort_keys=True) + "\n"
        if args.json == "-":
            sys.stdout.write(blob)
        else:
            Path(args.json).write_text(blob)
    else:
        for f in new:
            print(f.render())
        if stale:
            print(f"stale baseline entries (matched nothing — remove via "
                  f"--write-baseline):")
            for e in stale:
                print(f"  {e.get('rule')}[{e.get('code')}] "
                      f"{e.get('path')} ({e.get('fingerprint')})")
        print(f"capslint: {len(project.modules)} modules, "
              f"{len(errors)} error(s), {len(warnings)} warning(s), "
              f"{len(suppressed)} suppressed, {len(baselined)} baselined, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}")

    return 1 if gate_failed else 0


if __name__ == "__main__":
    sys.exit(main())

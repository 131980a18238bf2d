"""Structured findings, inline suppressions, and the committed baseline.

A :class:`Finding` is the one record type every checker emits: rule id,
sub-code, ``file:line``, message and fix hint.  Findings are *fingerprinted*
without their line number (rule, code, file, enclosing symbol, message), so
a committed baseline survives unrelated edits shifting lines around — the
same idea as the kernel autotune cache being keyed by shape bucket rather
than exact shape.

Two escape hatches let the gate land strict without blocking on history:

* **inline suppression** — ``# capslint: disable=<rule>`` trailing on the
  offending line (or the line directly above) waives that rule there; the
  comment doubles as the written justification a reader sees.
* **baseline** — ``tools/capslint_torch_baseline.json`` (the port's own
  file beside the reference's) holds fingerprints of
  accepted legacy findings; ``--write-baseline`` refreshes it, and the
  gate fails only on findings *not* in it.  A stale entry (nothing matches
  it any more) fails ``--strict`` so the baseline can only shrink.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

BASELINE_VERSION = 1

#: severities, most severe first; only ``error`` findings gate CI.
SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str                         # checker id, e.g. "lock-discipline"
    code: str                         # sub-rule, e.g. "unguarded-mutation"
    path: str                         # repo-relative posix path
    line: int                         # 1-based
    message: str                      # what is wrong (line-number-free, so
    #                                   fingerprints survive code motion)
    symbol: str = ""                  # enclosing "Class.method" when known
    severity: str = "error"
    hint: str = ""                    # how to fix or justify

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def fingerprint(self) -> str:
        """Stable identity for baselining: everything but the line."""
        blob = "|".join((self.rule, self.code, self.path, self.symbol,
                         self.message))
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    def render(self) -> str:
        out = (f"{self.location}: {self.severity}: "
               f"{self.rule}[{self.code}] {self.message}")
        if self.hint:
            out += f"  [hint: {self.hint}]"
        return out


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Canonical report order: severity, then location, then rule."""
    return sorted(findings, key=lambda f: (SEVERITIES.index(f.severity)
                                           if f.severity in SEVERITIES else 99,
                                           f.path, f.line, f.rule, f.code))


def apply_suppressions(project, findings: Iterable[Finding]
                       ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed) using the modules' inline
    ``# capslint: disable=`` comments.  A suppression names the rule, the
    ``rule.code``, or ``all``."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    by_relpath = {m.relpath: m for m in project.modules.values()}
    for f in findings:
        mod = by_relpath.get(f.path)
        disabled = mod.disabled_rules(f.line) if mod else set()
        if disabled & {f.rule, f"{f.rule}.{f.code}", "all"}:
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


class Baseline:
    """The committed set of accepted legacy findings (by fingerprint)."""

    def __init__(self, entries: Optional[Dict[str, Dict[str, Any]]] = None,
                 path: Optional[Path] = None):
        self.entries = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls({}, path=path)
        blob = json.loads(path.read_text())
        if blob.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"{path}: baseline version {blob.get('version')!r} != "
                f"{BASELINE_VERSION}; regenerate with --write-baseline")
        return cls({e["fingerprint"]: e for e in blob.get("findings", [])},
                   path=path)

    def save(self, path, findings: Iterable[Finding]) -> None:
        path = Path(path)
        payload = {
            "version": BASELINE_VERSION,
            "comment": ("accepted legacy capslint findings; shrink-only — "
                        "refresh with `python -m repro_torch.analysis "
                        "--write-baseline` and justify additions in review"),
            "findings": [
                {"fingerprint": f.fingerprint(), "rule": f.rule,
                 "code": f.code, "path": f.path, "symbol": f.symbol,
                 "message": f.message}
                for f in sort_findings(findings)],
        }
        path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")

    def split(self, findings: Iterable[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[Dict[str, Any]]]:
        """``(new, baselined, stale)``: findings not in the baseline,
        findings the baseline accepts, and baseline entries that matched
        nothing (dead weight ``--strict`` refuses to carry)."""
        findings = list(findings)
        seen = set()
        new, accepted = [], []
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                accepted.append(f)
                seen.add(fp)
            else:
                new.append(f)
        stale = [e for fp, e in sorted(self.entries.items())
                 if fp not in seen]
        return new, accepted, stale

"""Op analysis of a counted step: op census, layout copies, cross-device
copies (the port's twin of ``repro/launch/hlo_analysis.py``).

The reference reads the post-SPMD HLO text of a compiled step.  The port
reads the per-op tallies that :mod:`repro_torch.launch.op_cost` keeps while
the step dispatches (a :class:`~repro_torch.launch.op_cost.Cost`):

  * :func:`op_census`: the most frequent aten ops (remat shows up as
    repeated forward ops, a Python loop as ops counted once a trip);
  * :func:`reshape_transpose_bytes`: bytes of the copies that materialize a
    layout (``clone``, which is what ``contiguous`` of a permuted view
    dispatches, ``_to_copy`` on one device, ``copy_`` between layouts),
    the eager counterpart of the reference's transpose / reshape / copy
    bytes;
  * :func:`collective_stats`: the port has no collectives; what crosses
    devices are copies, counted under ``device_copy``.  A meta dry run has
    none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.launch.op_cost import Cost


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> float:
        return sum(self.count_by_kind.values())

    def summary(self) -> str:
        rows = [f"  {k:20s} n={int(self.count_by_kind[k]):4d} "
                f"bytes={self.bytes_by_kind[k]:.3e}"
                for k in sorted(self.bytes_by_kind)]
        return "\n".join(rows) if rows else "  (no collectives)"


def collective_stats(cost: Cost) -> CollectiveStats:
    """Bytes and counts of every collective and cross-device copy the
    counted function dispatched."""
    return CollectiveStats(dict(cost.collective_by_kind),
                           dict(cost.collective_count))


def op_census(cost: Cost, top: int = 15) -> List[Tuple[str, int]]:
    """Dispatch count per aten op (and per kernel row on meta), most
    frequent first."""
    return sorted(cost.op_counts.items(), key=lambda kv: -kv[1])[:top]


def reshape_transpose_bytes(cost: Cost) -> float:
    """Bytes written by copies that materialize a layout."""
    return cost.layout_copy_bytes

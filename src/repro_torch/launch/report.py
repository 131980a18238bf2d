"""Print the dry-run and roofline tables from the dry-run JSON records (the
port's twin of ``repro/launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List

from repro_torch.launch import roofline as rf


def gib(b: float) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(recs: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | mesh | args GiB/dev | temp GiB/dev | "
           "flops/dev | bytes/dev | coll bytes/dev | trace s | fits |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in recs:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {gib(r['arg_bytes_per_dev'])} "
            f"| {gib(r['temp_bytes_per_dev'])} "
            f"| {r['flops_per_dev']:.3e} "
            f"| {r['bytes_per_dev']:.3e} "
            f"| {r['collective_bytes_per_dev']:.3e} "
            f"| {r['trace_s']:.1f} | {'yes' if rf.fits(r) else '**no**'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--section", choices=["dryrun", "roofline", "both"],
                    default="both")
    args = ap.parse_args(argv)
    recs = rf.load_records(args.dir)
    recs.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    if args.section in ("dryrun", "both"):
        print("### Dry-run matrix\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("roofline", "both"):
        print("### Roofline (single-pod 16x16, H100)\n")
        rows = [rf.analyze(r) for r in recs if r["mesh"] == "16x16"]
        print(rf.to_markdown(rows))


if __name__ == "__main__":
    main()

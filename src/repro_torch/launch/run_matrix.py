"""Drive the full dry-run matrix, one subprocess of
``python -m repro_torch.launch.dryrun`` per cell (the port's twin of
``repro/launch/run_matrix.py``: a cell that fails or hangs cannot take down
the sweep).

    PYTHONPATH=src python -m repro_torch.launch.run_matrix \\
        --out experiments/dryrun_torch --mesh both
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Iterable, List, Optional, Sequence, Tuple


def matrix_cells() -> List[Tuple[str, str]]:
    """Every LM cell of ``configs.CELLS`` and every CapsNet cell."""
    from repro_torch import configs as cfg_lib
    from repro_torch.launch.dryrun import CAPSNET_SHAPES

    return list(cfg_lib.CELLS) + [
        (a, s) for a in cfg_lib.PAPER_ARCHS for s in CAPSNET_SHAPES]


def run_matrix(cells: Iterable[Tuple[str, str]], out: str,
               meshes: Sequence[str], hlo_dir: Optional[str] = None,
               skip_existing: bool = False, timeout: int = 2400) -> list:
    """Run each cell of ``cells`` on each mesh (``"single"`` / ``"multi"``)
    in its own subprocess; returns the failures."""
    from repro_torch import configs as cfg_lib

    failures = []
    for arch, shape in cells:
        status = (None if arch.startswith("capsnet")
                  else cfg_lib.cell_status(arch, shape))
        if status:
            print(f"[skip] {arch:22s} {shape:12s} {status}", flush=True)
            continue
        for mesh in meshes:
            mesh_name = "2x16x16" if mesh == "multi" else "16x16"
            if skip_existing:
                f = os.path.join(out, f"{arch}__{shape}__{mesh_name}.json")
                if os.path.exists(f):
                    print(f"[have] {arch:22s} {shape:12s} {mesh_name}",
                          flush=True)
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", out]
            if hlo_dir and mesh == "single":
                cmd += ["--hlo-dir", hlo_dir]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout)
                ok_lines = [line for line in r.stdout.splitlines()
                            if line.startswith("[ ok ]")]
                if r.returncode == 0 and ok_lines:
                    print(ok_lines[-1], flush=True)
                else:
                    failures.append((arch, shape, mesh_name))
                    tail = (r.stdout + r.stderr).strip().splitlines()[-6:]
                    print(f"[FAIL] {arch} {shape} {mesh_name}:", flush=True)
                    for line in tail:
                        print("   ", line, flush=True)
            except subprocess.TimeoutExpired:
                failures.append((arch, shape, mesh_name, "timeout"))
                print(f"[TIMEOUT] {arch} {shape} {mesh_name}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--hlo-dir", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    t0 = time.time()
    failures = run_matrix(matrix_cells(), args.out, meshes, args.hlo_dir,
                          args.skip_existing, args.timeout)
    dt = time.time() - t0
    print(f"\nmatrix done in {dt/60:.1f} min; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", *f)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()

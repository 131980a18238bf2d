"""Serve a (reduced) assigned-architecture LM with batched requests
through the port's slot-based engine (``repro_torch.launch.serve``).

    PYTHONPATH=src python examples/pt_serve_lm.py                  # the card
    PYTHONPATH=src python examples/pt_serve_lm.py --device cpu
    PYTHONPATH=src python examples/pt_serve_lm.py --arch deepseek-moe-16b \\
        --device cpu

Every other argument goes to the launcher as it is (``--decode-kernel
--attn-impl cuda`` for the hand-written kernels, ``--paged``, ...).
"""

import subprocess
import sys

if __name__ == "__main__":
    args = sys.argv[1:]
    if not any(a.startswith("--arch") for a in args):
        args = ["--arch", "llama3.2-1b"] + args
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--requests", "6", "--slots", "3", "--max-new", "10"] + args
    raise SystemExit(subprocess.call(cmd))

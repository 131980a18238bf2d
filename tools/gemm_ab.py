#!/usr/bin/env python
"""The fixed-order GEMM of this tree (``src/repro_torch/csrc/gemm.cu``)
against another version of the same source, on the card.

At each of ``chip_smoke.py``'s GEMM geometries (llama3.2-1b's projections
at the prefill's M and at a decode tick's, the unembed at the tick's) and
at 3 slots, both versions run on the same inputs: whether they give every
output the same bits, and each one's time by CUDA events, taken in the
order other, this, this, other, beside cuBLAS (``x @ w``).  A time is the
median over ``--repeats`` readings of ``--inner`` back-to-back launches
between two events, divided by ``--inner``: the launches queue ahead of
the card, so a small product reads its kernel's time, not the host's.

The other version is compiled on its own (``nvcc`` with the flags of
``kernels/build.py``, this tree's ``csrc`` headers) into a library beside
the tree's; both are called through their C entry points, with the same
arguments.  It needs one CUDA device.  From the repo root, on the card::

    python3 tools/gemm_ab.py --other path/to/other/gemm.cu

One JSON object a line: the card (``nvidia-smi``'s name and power limit),
then one per geometry.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gemm.kernel import (  # noqa: E402
    fixed_order_matmul_plain, w_layout)


ENTRY = "fixed_order_matmul_launch"


def load_other(source: str):
    """``source`` compiled and linked into its own library under the
    build directory, every symbol renamed (its namespace by a macro, its
    entry point in a copy of the text) so that none of it binds to the
    tree's library; returns the entry point, declared."""
    out = build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    text = open(source).read()
    if f" {ENTRY}(" not in text:
        raise SystemExit(f"{source}: no {ENTRY}")
    src = out / "gemm_other.cu"
    src.write_text(text.replace(f" {ENTRY}(", f" {ENTRY}_other("))
    obj, lib = out / "gemm_other.o", out / "libgemm_other.so"
    nvcc = build.find_nvcc()
    for cmd in ([nvcc, *build.NVCC_FLAGS, "-Dfastcaps=fastcaps_other", "-I",
                 str(build.CSRC_DIR), "-c", str(src), "-o", str(obj)],
                [nvcc, "-shared", "-o", str(lib), str(obj)]):
        subprocess.run(cmd, check=True)
    fn = getattr(ctypes.CDLL(str(lib)), ENTRY + "_other")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def median_ms(fn, repeats: int, inner: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other version of csrc/gemm.cu")
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--inner", type=int, default=20)
    args = ap.parse_args()
    this = build.load_library().fixed_order_matmul_launch
    other = load_other(args.other)
    print(json.dumps({"card": cs.nvidia_smi_line()}), flush=True)
    cases = [case for _, case in cs.GEMM_TIMINGS] + [
        cs.gemm_case(3, n, k, layout)
        for _, n, k, layout in cs.GEMM_PROJECTIONS + (cs.GEMM_UNEMBED,)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in cases:
        m, n, k = case["dims"]
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
             ).to(torch.bfloat16)
        if case["layout"] == "nk":
            w = w.T.contiguous().T
        ys = {v: torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
              for v in ("this", "other")}
        index = x.get_device()
        nk = int(w_layout(w) == "nk")

        def runner(entry, y):
            def run():
                build.check_launch(entry(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, nk, 1,
                    index, build.raw_stream(index)), "fixed_order_matmul")
            return run

        run_this, run_other = (runner(this, ys["this"]),
                               runner(other, ys["other"]))
        run_this()
        run_other()
        same = torch.equal(ys["this"], ys["other"])
        vs_plain = float((ys["this"].float() - fixed_order_matmul_plain(
            x, w).float()).abs().max())
        timed = {"other_ms": [median_ms(run_other, args.repeats, args.inner)]}
        timed["this_ms"] = [median_ms(run_this, args.repeats, args.inner)
                            for _ in range(2)]
        timed["other_ms"].append(median_ms(run_other, args.repeats,
                                           args.inner))
        print(json.dumps({
            "m": m, "n": n, "k": k, "layout": case["layout"],
            "bit_identical": same, "max_abs_vs_cublas": vs_plain, **timed,
            "cublas_ms": median_ms(lambda: x @ w, args.repeats, args.inner)}),
            flush=True)
        del x, w, ys
    return 0


if __name__ == "__main__":
    sys.exit(main())

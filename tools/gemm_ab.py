#!/usr/bin/env python
"""The fixed-order GEMM of this tree (``src/repro_torch/csrc/gemm.cu``)
against other versions of the same source, on the card.

A version is either another file (``--other path/to/gemm.cu``, e.g. an
earlier commit's) or this tree's source with its BN rule fixed to one
value (``--bn 64,128,256``: ``gemm_block_n`` then returns that value for
every product), to measure a BN rule before it is kept.

At each of ``chip_smoke.py``'s GEMM geometries (llama3.2-1b's projections
at the prefill's M and at a decode tick's, the unembed at the tick's) and
at 3 slots, every version runs on the same inputs: whether each gives
every output the bits of this tree's, its largest difference from cuBLAS
(``x @ w``), and its time by CUDA events, taken in the order others, this,
this, others reversed, beside cuBLAS's.  A time is the median over
``--repeats`` readings of ``--inner`` back-to-back launches between two
events, divided by ``--inner``: the launches queue ahead of the card, so a
small product reads its kernel's time, not the host's.

``--probe`` also holds each version's rows still across M: the first rows
of x through each geometry's weight at every M of ``PROBE_M``, each against
the same rows at the largest M; a row that parts is reported
(``"parted"``), and the tool exits 1.

Each other version is compiled on its own (``nvcc`` with the flags of
``kernels/build.py``, this tree's ``csrc`` headers; ``--ptxas`` adds
``-Xptxas -v`` and prints each bf16 kernel's registers and spills) into a
library beside the tree's; all are called through their C entry points,
with the same arguments.  It needs one CUDA device.  From the repo root,
on the card::

    python3 tools/gemm_ab.py --other path/to/other/gemm.cu --bn 64,128 --probe

One JSON object a line: the card (``nvidia-smi``'s name and power limit),
then one per geometry (and per probed geometry).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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
RULE = re.compile(r"(inline int gemm_block_n\([^)]*\) \{\n)(.*?)(\n\})",
                  re.S)
PROBE_M = (1, 3, 8, 17, 64, 65, 75, 127, 128, 129, 1000, 8192)


def fixed_bn_source(bn: int) -> str:
    """This tree's gemm.cu with its BN rule returning ``bn``."""
    text = (build.CSRC_DIR / "gemm.cu").read_text()
    if not RULE.search(text):
        raise SystemExit("gemm.cu: no gemm_block_n rule to fix")
    return RULE.sub(lambda m: f"{m.group(1)}  return {bn};{m.group(3)}",
                    text, count=1)


def start_build(label: str, text: str, ptxas: bool):
    """Starts compiling ``text`` (a version of gemm.cu) into its own
    library under the build directory, every symbol renamed (its
    namespace by a macro, its entry point in a copy of the text) so that
    none of it binds to the tree's library."""
    if f" {ENTRY}(" not in text:
        raise SystemExit(f"{label}: no {ENTRY}")
    out = build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"\W", "_", label)
    src = out / f"gemm_{tag}.cu"
    src.write_text(text.replace(f" {ENTRY}(", f" {ENTRY}_{tag}("))
    obj, lib = out / f"gemm_{tag}.o", out / f"libgemm_{tag}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, f"-Dfastcaps=fastcaps_{tag}",
           "-I", str(build.CSRC_DIR), *(["-Xptxas", "-v"] if ptxas else []),
           "-c", str(src), "-o", str(obj)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return label, tag, obj, lib, proc


def finish_build(label, tag, obj, lib, proc, ptxas: bool):
    """Waits for start_build's compile, links and loads; returns the entry
    point, declared."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"{label}: nvcc failed\n{out}")
    if ptxas:
        print_ptxas(label, out)
    subprocess.run([build.find_nvcc(), "-shared", "-o", str(lib), str(obj)],
                   check=True)
    fn = getattr(ctypes.CDLL(str(lib)), f"{ENTRY}_{tag}")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def print_ptxas(label: str, out: str) -> None:
    """ptxas's registers, spills and shared memory of each bf16 kernel."""
    name = None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "fixed_order_gemm_bf16" in name and re.search(
                r"registers|spill", line):
            print(json.dumps({"version": label, "kernel": name,
                              "ptxas": line.strip()}), flush=True)


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


def operands(case, gen):
    m, n, k = case["dims"]
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
         ).to(torch.bfloat16)
    if case["layout"] == "nk":
        w = w.T.contiguous().T
    return x, w


def runner(entry, x, w, y):
    """One launch of ``entry`` on x[:m] @ w into y (m = y's rows)."""
    m, n, k = y.shape[0], w.shape[1], w.shape[0]
    index = x.get_device()
    nk = int(w_layout(w) == "nk")

    def run():
        build.check_launch(entry(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, nk, 1, index,
            build.raw_stream(index)), "fixed_order_matmul")
    return run


def compare(versions, case, gen, args) -> dict:
    x, w = operands(case, gen)
    m, n, k = case["dims"]
    ys = {v: torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
          for v in versions}
    runs = {v: runner(entry, x, w, ys[v]) for v, entry in versions.items()}
    for run in runs.values():
        run()
    plain = fixed_order_matmul_plain(x, w).float()
    out = {"m": m, "n": n, "k": k, "layout": case["layout"],
           "bit_identical_to_this": {v: torch.equal(ys[v], ys["this"])
                                     for v in versions if v != "this"},
           "max_abs_vs_cublas": {v: float((y.float() - plain).abs().max())
                                 for v, y in ys.items()}}
    others = [v for v in versions if v != "this"]
    timed = {v: [] for v in versions}
    for v in others:
        timed[v].append(median_ms(runs[v], args.repeats, args.inner))
    for _ in range(2):
        timed["this"].append(median_ms(runs["this"], args.repeats,
                                       args.inner))
    for v in reversed(others):
        timed[v].append(median_ms(runs[v], args.repeats, args.inner))
    out["ms"] = timed
    out["cublas_ms"] = median_ms(lambda: x @ w, args.repeats, args.inner)
    return out


def probe(versions, case, gen) -> dict:
    """Each version's first rows at every M of PROBE_M against the same rows
    at the largest M."""
    _, n, k = case["dims"]
    x, w = operands({**case, "dims": (PROBE_M[-1], n, k)}, gen)
    out = {"n": n, "k": k, "layout": case["layout"], "parted": {}}
    for v, entry in versions.items():
        y = torch.empty(PROBE_M[-1], n, dtype=torch.bfloat16, device="cuda")
        runner(entry, x, w, y)()
        parted = []
        for m in PROBE_M[:-1]:
            part = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            runner(entry, x, w, part)()
            if not torch.equal(part, y[:m]):
                parted.append(m)
        out["parted"][v] = parted
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another version of csrc/gemm.cu (repeatable)")
    ap.add_argument("--bn", default="",
                    help="comma-separated BNs: this tree's source with its "
                         "BN rule fixed to each")
    ap.add_argument("--probe", action="store_true",
                    help="hold each version's rows across M")
    ap.add_argument("--ptxas", action="store_true",
                    help="print each version's registers and spills")
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--inner", type=int, default=20)
    args = ap.parse_args()
    pending = [start_build(f"other{i}:{os.path.basename(path)}",
                           open(path).read(), args.ptxas)
               for i, path in enumerate(args.other)]
    pending += [start_build(f"bn{bn}", fixed_bn_source(int(bn)), args.ptxas)
                for bn in args.bn.split(",") if bn]
    if args.ptxas:
        pending.append(start_build(
            "this", (build.CSRC_DIR / "gemm.cu").read_text(), True))
    versions = {"this": build.load_library().fixed_order_matmul_launch}
    for item in pending:
        fn = finish_build(*item, args.ptxas)
        if item[0] != "this":
            versions[item[0]] = fn
    print(json.dumps({"card": cs.nvidia_smi_line()}), flush=True)
    cases = [case for _, case in cs.GEMM_TIMINGS] + [
        cs.gemm_case(3, n, k, layout)
        for _, n, k, layout in cs.GEMM_PROJECTIONS + (cs.GEMM_UNEMBED,)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    parted = False
    for case in cases:
        print(json.dumps(compare(versions, case, gen, args)), flush=True)
        torch.cuda.empty_cache()
    if args.probe:
        for _, n, k, layout in cs.GEMM_PROJECTIONS + (cs.GEMM_UNEMBED,):
            out = probe(versions, cs.gemm_case(1, n, k, layout), gen)
            parted |= any(out["parted"].values())
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 1 if parted else 0


if __name__ == "__main__":
    sys.exit(main())

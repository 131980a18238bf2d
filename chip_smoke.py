#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100, ``sm_90a``) and the CUDA toolkit;
takes no arguments.  It builds the port's CUDA kernels from
``src/repro_torch/csrc``, holds every kernel against its plain PyTorch
version on the card, serves a LAKP-pruned and a dense full-width
``capsnet-mnist`` through ``CapsuleEngine`` with the routing in the
hand-written kernel, and times the kernels.  One JSON object per phase goes
to standard output; the last three lines are the kernel table, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  Any failed
phase ends the script with a non-zero exit code and no result line.  With no
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import configs as cfg_lib  # noqa: E402
from repro_torch.deploy import FastCapsPipeline  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.registry import registry  # noqa: E402
from repro_torch.kernels.routing.routing_kernel import fused_routing_cuda  # noqa: E402
from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda  # noqa: E402
from repro_torch.serving import ImageRequest  # noqa: E402

DEVICE = "cuda"
BATCH = 32
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores

WRAPPERS = {"fused_routing": fused_routing_cuda,
            "taylor_softmax": taylor_softmax_cuda}

# Where each kernel lives, what it replaces, and the shape the main path
# gives it (serve_pruned at batch 32: 252 capsules after compaction).
KERNELS = {
    "fused_routing": {
        "route": "cuda", "source": "src/repro_torch/csrc/routing.cu",
        "replaces": "src/repro/kernels/routing/routing_kernel.py:93",
        "main_case": {"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor"},
    },
    "taylor_softmax": {
        "route": "cuda", "source": "src/repro_torch/csrc/softmax.cu",
        "replaces": "src/repro/kernels/softmax/kernel.py:43",
        "main_case": {"shape": (BATCH, 252, 10), "scale": 1.0},
    },
}

# Main-path shapes beyond the registry's example cases.  Tolerances: the
# kernels sum in another order than the plain versions and use rsqrtf/expf,
# so float32 agrees to a few ulp of values <= 1 (1e-5 exact routing, 1e-4
# with the polynomial, whose five squarings multiply a rounding difference by
# 32; 1e-6 for the softmax alone); bfloat16 outputs round at 2^-8 (1e-2).
EXTRA_CASES = {
    "fused_routing": (
        {"shape": (BATCH, 252, 10, 16), "softmax_mode": "exact", "atol": 1e-5},
        {"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor", "atol": 1e-4},
        {"shape": (BATCH, 1152, 10, 16), "softmax_mode": "exact", "atol": 1e-5},
        {"shape": (BATCH, 1152, 10, 16), "softmax_mode": "taylor", "atol": 1e-4},
        {"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor",
         "dtype": "bfloat16", "atol": 1e-2},
        # D not a power of two: the agreement step's path without shuffles
        {"shape": (2, 20, 3, 12), "softmax_mode": "taylor", "atol": 1e-4},
    ),
    "taylor_softmax": (
        {"shape": (BATCH * 252, 10), "scale": 1.0, "atol": 1e-6},
        {"shape": (BATCH, 252, 10), "scale": 1.0, "atol": 1e-6},
        {"shape": (1, 1024), "atol": 1e-6},
    ),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def median_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``launches`` back-to-back
    calls, by CUDA events, after a warm-up.  The inputs stay in L2 between
    calls, as they are on the serve path (u_hat was just written)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(build.build_dir()), sources=list(build.SOURCES))


def phase_kernels() -> dict:
    """Every kernel against its plain version on the card; returns the
    largest error per kernel."""
    worst = {}
    for name in registry.names():
        spec = registry.get(name)
        wrapper = spec.build()
        worst[name] = 0.0
        for case in tuple(spec.example_cases) + EXTRA_CASES[name]:
            args, kwargs = spec.make_example(case, device=DEVICE)
            cfg = registry.default_config(name, *args, **kwargs)
            got = as_tuple(wrapper(*args, **kwargs, **cfg))
            torch.cuda.synchronize()
            want = as_tuple(spec.ref_call(*args, **kwargs))
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            again = as_tuple(wrapper(*args, **kwargs, **cfg))
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            emit("kernels", kernel=name, shape=list(case["shape"]),
                 dtype=case.get("dtype", "float32"),
                 softmax_mode=kwargs.get("softmax_mode"), config=cfg,
                 max_abs_err=err, atol=case["atol"], bit_identical=identical)
            if not finite:
                fail(f"{name} {case}: non-finite output")
            if err > case["atol"]:
                fail(f"{name} {case}: max abs err {err} > {case['atol']}")
            if not identical:
                fail(f"{name} {case}: two runs differ")
            worst[name] = max(worst[name], err)
    return worst


def make_requests(n_requests: int, cfg) -> list:
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n_requests):
        n = int(rng.randint(1, 2 * BATCH))           # 1 .. 63 frames
        reqs.append(ImageRequest(
            images=rng.rand(n, cfg.image_hw, cfg.image_hw,
                            cfg.in_channels).astype(np.float32), rid=i))
    return reqs


def reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def serve(deployed, requests):
    """Serve ``requests`` through a fresh CapsuleEngine; the launch counts
    are set to 0 after the warm-up and read right after the run."""
    engine = deployed.serve(batch_size=BATCH)
    engine.warmup()
    reset_counts()
    for r in requests:
        engine.submit(ImageRequest(images=r.images, rid=r.rid))
    completions = engine.run_until_idle()
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    return completions, engine.stats(), counts


def forward_breakdown(deployed, n_forwards: int = 20) -> dict:
    """Where a full tick's time goes, at the engine's batch size.

    ``step_wall_ms``: host wall-clock of the engine's own step (pinned copy
    in, forward, copy out; median of 20).  ``forward_wall_ms``: host
    wall-clock per forward of ``n_forwards`` back-to-back forwards ending in
    a synchronise.  ``device_busy_ms``: the sum of the kernels' device times
    per forward from ``torch.profiler`` (None when the profiler reports no
    device time), with the busiest kernels by name; the device's idle share
    of a forward is what is left of the wall-clock."""
    cfg = deployed.cfg
    rng = np.random.RandomState(1)
    batch = rng.rand(BATCH, cfg.image_hw, cfg.image_hw,
                     cfg.in_channels).astype(np.float32)
    engine = deployed.serve(batch_size=BATCH)
    engine.warmup()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.forward_host(batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    out = {"step_wall_ms": walls[len(walls) // 2]}

    x = torch.from_numpy(batch).to(DEVICE)
    deployed.forward(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_forwards):
        deployed.forward(x)
    torch.cuda.synchronize()
    out["forward_wall_ms"] = (time.perf_counter() - t0) * 1e3 / n_forwards

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_forwards):
            deployed.forward(x)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        # kernel events only: an operator's entry repeats the device time of
        # the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            name = ev.key[:60]
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / n_forwards
    busy = sum(kernels.values())
    out["device_busy_ms"] = busy if busy > 0 else None
    out["device_idle_share_of_forward"] = (
        max(0.0, 1.0 - busy / out["forward_wall_ms"]) if busy > 0 else None)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out["device_ms_by_kernel"] = dict(top)
    return out


def phase_serve(phase: str, prune: bool, n_requests: int) -> dict:
    """Full-width capsnet-mnist through FastCapsPipeline and CapsuleEngine,
    once with the fused routing kernel (variant ``cuda``) and once with the
    unfused variant ``optimized``, on the same parameters and requests."""
    cfg = cfg_lib.get_config("capsnet-mnist")
    pipe = FastCapsPipeline(cfg, device=DEVICE).build(seed=0)
    if prune:
        pipe.prune(0.6, 0.9, type_keep=7).compact()
    fused = pipe.compile(routing="cuda")
    unfused = pipe.compile(routing="optimized")
    want_caps = 252 if prune else 1152
    if fused.cfg.n_primary_caps != want_caps:
        fail(f"{phase}: {fused.cfg.n_primary_caps} capsules, "
             f"expected {want_caps}")
    requests = make_requests(n_requests, fused.cfg)

    done, stats, counts = serve(fused, requests)
    done_ref, _, counts_ref = serve(unfused, requests)
    if counts["fused_routing"] != stats.ticks:
        fail(f"{phase}: routing kernel launched {counts['fused_routing']} "
             f"times in {stats.ticks} ticks")
    if counts_ref["taylor_softmax"] != stats.ticks * fused.cfg.routing_iters:
        fail(f"{phase}: softmax kernel launched "
             f"{counts_ref['taylor_softmax']} times by the unfused variant")
    if len(done) != n_requests or len(done_ref) != n_requests:
        fail(f"{phase}: {len(done)} of {n_requests} requests completed")
    by_rid = {c.rid: c for c in done}
    by_rid_ref = {c.rid: c for c in done_ref}
    max_err, ambiguous = 0.0, 0
    for r in requests:
        c, c_ref = by_rid[r.rid], by_rid_ref[r.rid]
        if c.lengths.shape != (len(r.images), fused.cfg.n_classes):
            fail(f"{phase}: rid {r.rid} has lengths {c.lengths.shape}")
        if not np.isfinite(c.lengths).all():
            fail(f"{phase}: rid {r.rid} has non-finite lengths")
        max_err = max(max_err, float(np.abs(c.lengths - c_ref.lengths).max()))
        # classes must agree wherever the winner is clear of the tolerance
        top2 = np.sort(c_ref.lengths, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2e-4
        ambiguous += int((~clear).sum())
        if not np.array_equal(c.classes[clear], c_ref.classes[clear]):
            fail(f"{phase}: rid {r.rid} classes differ between variants")
    if max_err > 1e-4:
        fail(f"{phase}: lengths differ by {max_err} > 1e-4 between variants")

    lat = stats.latency_summary()
    emit(phase, capsules=fused.cfg.n_primary_caps, params=fused.n_params,
         mflop_per_image=fused.flops_per_image / 1e6,
         requests=stats.completed, frames=stats.frames, ticks=stats.ticks,
         padded_frames=stats.padded_frames, fps=stats.fps,
         ms_per_tick=stats.ms_per_tick,
         latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                     for k, (n, p50, p95) in lat.items()},
         routing_launches=counts["fused_routing"],
         softmax_launches_unfused=counts_ref["taylor_softmax"],
         max_abs_err_vs_optimized=max_err, ambiguous_frames=ambiguous,
         **forward_breakdown(fused))
    return {"fused_routing": counts["fused_routing"],
            "taylor_softmax": counts_ref["taylor_softmax"]}


def routing_bound(shape, n_iters: int = 3):
    b, i, j, d = shape
    nbytes = 4 * (b * i * j * d + b * j * d + b * i * j)
    flops = (n_iters * 2 * b * i * j * d            # FC
             + (n_iters - 1) * 2 * b * i * j * d    # agreement
             + n_iters * 6 * b * i * j              # softmax
             + n_iters * 6 * b * j * d)             # squash
    return nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S


def softmax_bound(shape):
    n = int(np.prod(shape))
    # per element: subtract, clamp (2), scale, Horner (10), e^a, 5 squarings,
    # the sum, the division, and the maximum
    return 2 * 4 * n / HBM_BYTES_PER_S, 23 * n / FP32_FLOP_PER_S


def phase_timings(launches: dict, worst: dict) -> list:
    table = []
    for name, info in KERNELS.items():
        spec = registry.get(name)
        case = info["main_case"]
        args, kwargs = spec.make_example(case, device=DEVICE)
        cfg = registry.default_config(name, *args, **kwargs)
        wrapper = spec.build()
        ms = median_ms(lambda: wrapper(*args, **kwargs, **cfg))
        plain_ms = median_ms(lambda: spec.ref_call(*args, **kwargs))
        t_bytes, t_ops = (routing_bound(case["shape"])
                          if name == "fused_routing"
                          else softmax_bound(case["shape"]))
        row = {"name": name, "route": info["route"], "source": info["source"],
               "replaces": info["replaces"], "launches": launches[name],
               "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               # no single PyTorch call computes either function
               "library_ms": None,
               "shape": list(case["shape"]), "config": cfg}
        table.append(row)
        emit("timings", **row)
    # the dense serve path's shape, for the record beside the main one
    spec = registry.get("fused_routing")
    case = {"shape": (BATCH, 1152, 10, 16), "softmax_mode": "taylor"}
    args, kwargs = spec.make_example(case, device=DEVICE)
    wrapper = spec.build()
    per_threads = {}
    for threads in spec.space["threads"]:
        per_threads[str(threads)] = median_ms(
            lambda: wrapper(*args, **kwargs, threads=threads))
    t_bytes, t_ops = routing_bound(case["shape"])
    emit("timings", name="fused_routing", shape=list(case["shape"]),
         ms_by_threads=per_threads,
         plain_ms=median_ms(lambda: spec.ref_call(*args, **kwargs)),
         bound_ms=max(t_bytes, t_ops) * 1e3,
         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return table


def main() -> None:
    if len(sys.argv) > 1:
        sys.exit("chip_smoke takes no arguments")
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    worst = phase_kernels()
    launches = phase_serve("serve_pruned", prune=True, n_requests=8)
    launches_dense = phase_serve("serve_dense", prune=False, n_requests=4)
    for name, n in {**launches, **{f"{k} (dense)": v
                                   for k, v in launches_dense.items()}}.items():
        if n < 1:
            fail(f"{name} was never launched on the serve path")
    table = phase_timings(launches, worst)
    emit("done", seconds=time.perf_counter() - t0,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

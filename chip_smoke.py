#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100, ``sm_90a``) and the CUDA toolkit;
takes no arguments.  It builds the port's CUDA kernels from
``src/repro_torch/csrc``, holds every kernel against its plain PyTorch
version on the card, serves a LAKP-pruned and a dense full-width
``capsnet-mnist`` through ``CapsuleEngine`` with the routing in the
hand-written kernel, serves a full-width ``llama3.2-1b`` (random weights,
seed 0) through ``ServeEngine`` with prefill attention, decode attention and
sampling in the hand-written kernels, and times the kernels.  One JSON
object per phase goes to standard output; the last three lines are the
kernel table, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Any failed phase ends the script with a non-zero exit
code and no result line.  With no CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain, flash_attention_cuda,
    flash_attention_plain)
from repro_torch.kernels.registry import registry  # noqa: E402
from repro_torch.kernels.routing.routing_kernel import fused_routing_cuda  # noqa: E402
from repro_torch.kernels.sampling.kernel import fused_sampling_cuda  # noqa: E402
from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serving import ImageRequest, Request, ServeEngine  # noqa: E402

DEVICE = "cuda"
BATCH = 32
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense

WRAPPERS = {"fused_routing": fused_routing_cuda,
            "taylor_softmax": taylor_softmax_cuda,
            "flash_attention": flash_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "fused_sampling": fused_sampling_cuda}

# The LM serving path (phase serve_lm): llama3.2-1b at full width, 8 slots
# of 1024 positions, 16 requests of 16-700 prompt tokens and 32 new tokens.
LM_ARCH = "llama3.2-1b"
LM_SLOTS = 8
LM_MAX_LEN = 1024
LM_REQUESTS = 16
LM_MAX_NEW = 32
# Greedy tokens of the kernel path and the plain path must agree up to the
# first position whose top-2 logit margin (on the plain path) is below this:
# logits are bf16 products (about |45| at this width, where a bf16 step is
# 0.25) after 16 layers whose attention sums run in another order on the two
# paths, so margins under four steps may flip.
LM_MARGIN = 1.0

# Where each kernel lives, what it replaces, and the shape the main path
# gives it (serve_pruned at batch 32: 252 capsules after compaction; the
# serve_lm prefill at 8 x 1024 positions and its decode tick over 8 slots).
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
    "flash_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:108",
        "main_case": {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 32, 8, 64),
                      "dtype": "bfloat16", "causal": True},
    },
    "decode_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:387",
        # "valid": the first 8 serve_lm prompts, 16 tokens into decode
        "main_case": {"dims": (LM_SLOTS, LM_MAX_LEN, 32, 8, 64),
                      "dtype": "bfloat16"},
    },
    "fused_sampling": {
        "route": "cuda", "source": "src/repro_torch/csrc/sampling.cu",
        "replaces": "src/repro/kernels/sampling/kernel.py:29",
        "main_case": {"dims": (LM_SLOTS, 128256),
                      "temperature": (0.0,) * LM_SLOTS},
    },
}

# The kernels' plain versions where the registry's reference is an oracle
# of another form (the other kernels' references are their plain versions).
PLAIN = {"flash_attention": flash_attention_plain,
         "decode_attention": decode_attention_plain}

# Sampling rows of the serve mix: greedy and (0.8, top-k 50, top-p 0.9).
MIXED = {"temperature": (0.8,) * LM_SLOTS, "top_k": (50,) * LM_SLOTS,
         "top_p": (0.9,) * LM_SLOTS}

# Main-path shapes beyond the registry's example cases.  Tolerances: the
# kernels sum in another order than the plain versions and use rsqrtf/expf,
# so float32 agrees to a few ulp of values <= 1 (1e-5 exact routing, 1e-4
# with the polynomial, whose five squarings multiply a rounding difference by
# 32; 1e-6 for the softmax alone; 2e-5 for exact float32 attention over up
# to 1024 rows); bfloat16 outputs round at 2^-8 (1e-2); attention with the
# polynomial exp is held against the exact oracle (5e-2, the approximation's
# own error); sampled tokens are integers and must be equal (0).
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
    "flash_attention": (
        # the serve_lm prefill: 8 prompts rounded up to 1024 positions
        {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 32, 8, 64),
         "dtype": "bfloat16", "causal": True, "atol": 1e-2},
        {"dims": (8, 512, 512, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (8, 512, 512, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "softmax_mode": "taylor", "atol": 5e-2},
        {"dims": (2, 1024, 1024, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        # qwen3 widths (D = 128, G = 2), S not a power of two
        {"dims": (1, 192, 192, 16, 8, 128), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (2, 256, 256, 32, 8, 64), "causal": True, "atol": 2e-5},
        # continuation prefill: 100 fresh rows after 412 cached ones
        {"dims": (2, 100, 512, 32, 8, 64), "causal": True, "q_offset": 412,
         "atol": 2e-5},
    ),
    "decode_attention": (
        {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16",
         "valid": (0, 1, 1023, 1024, 700, 17, 512, 300), "atol": 1e-2},
        {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16",
         "valid": (0, 1, 1023, 1024, 700, 17, 512, 300),
         "softmax_mode": "taylor", "atol": 5e-2},
        {"dims": (8, 1024, 32, 8, 64),
         "valid": (1024, 1, 1023, 33, 700, 17, 512, 300), "atol": 2e-5},
        # a float32 model's query against the bfloat16 cache
        {"dims": (8, 1024, 32, 8, 64), "kv_dtype": "bfloat16",
         "valid": (1024, 1, 1023, 33, 700, 17, 512, 300), "atol": 2e-5},
        {"dims": (4, 512, 16, 8, 128), "dtype": "bfloat16",
         "valid": (512, 100, 0, 333), "atol": 1e-2},
    ),
    "fused_sampling": (
        {"dims": (8, 128256), "temperature": (0.0,) * 8, "atol": 0},
        {"dims": (8, 128256), **MIXED, "atol": 0},
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


def case_shape(case) -> list:
    return list(case.get("shape") or case.get("dims"))


def phase_kernels() -> dict:
    """Every kernel against its reference on the card (the plain version,
    or for attention the exact float32 oracle, which the exact-mode plain
    version equals); returns the largest error per kernel.  The paged and
    int8 decode cases wait for the paged slice: their wrapper raises."""
    worst = {}
    for name in registry.names():
        spec = registry.get(name)
        wrapper = spec.build()
        worst[name] = 0.0
        for case in tuple(spec.example_cases) + EXTRA_CASES[name]:
            if case.get("paged") or case.get("quant"):
                emit("kernels", kernel=name, shape=case_shape(case),
                     skipped="paged or int8 cache: paged slice")
                continue
            atol = case.get("atol", 0)
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
            extra = {}
            if name in PLAIN and kwargs.get("softmax_mode") == "taylor":
                plain = PLAIN[name](*args, **kwargs)
                extra["max_abs_err_vs_plain_taylor"] = float(
                    (got[0].float() - plain.float()).abs().max())
            emit("kernels", kernel=name, shape=case_shape(case),
                 dtype=case.get("dtype", "float32"),
                 softmax_mode=kwargs.get("softmax_mode"), config=cfg,
                 max_abs_err=err, atol=atol, bit_identical=identical,
                 **extra)
            if not finite:
                fail(f"{name} {case}: non-finite output")
            if err > atol:
                fail(f"{name} {case}: max abs err {err} > {atol}")
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

    kernels = kernel_device_ms(lambda: deployed.forward(x), n_forwards)
    busy = sum(kernels.values())
    out["device_busy_ms"] = busy if busy > 0 else None
    out["device_idle_share_of_forward"] = (
        max(0.0, 1.0 - busy / out["forward_wall_ms"]) if busy > 0 else None)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out["device_ms_by_kernel"] = dict(top)
    return out


def kernel_device_ms(fn, n_calls: int) -> dict:
    """Device time per call of every kernel ``fn`` launches, by name, from
    ``torch.profiler`` kernel events over ``n_calls`` calls (empty when the
    profiler reports no device time)."""
    return profile_ms(fn, n_calls)[0]


def profile_ms(fn, n_calls: int):
    """``(device ms per call by kernel, host ms per call by operation)``
    from one ``torch.profiler`` trace of ``n_calls`` calls.  Device: kernel
    events only (an operator's entry repeats the device time of the
    kernels it launched).  Host: self CPU time of each operator and CUDA
    runtime call, with the profiler's own overhead in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    kernels, host = {}, {}
    for ev in prof.key_averages():
        name = ev.key[:60]
        if ev.device_type != DeviceType.CUDA:
            host[name] = ev.self_cpu_time_total / 1e3 / n_calls
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / n_calls
    return kernels, host


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


def lm_requests(vocab: int) -> list:
    """16 requests from RandomState(0): prompts of 16-700 tokens with ids in
    [1, vocab / 2), 32 new tokens; every fourth samples at temperature 0.8
    with top-k 50 and top-p 0.9 and a seed of its own, the others are
    greedy."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(LM_REQUESTS):
        n = int(rng.randint(16, 701))
        prompt = [int(t) for t in rng.randint(1, vocab // 2, size=n)]
        kw = {}
        if i % 4 == 3:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1000 + i)
        reqs.append(Request(prompt=prompt, max_new_tokens=LM_MAX_NEW, rid=i,
                            **kw))
    return reqs


def fresh(reqs: list) -> list:
    return [dataclasses.replace(r, prompt=list(r.prompt)) for r in reqs]


def count_calls(engine, method: str) -> list:
    """Count the calls of one of ``engine``'s hooks (prefill groups, decode
    ticks) by wrapping it on the instance."""
    calls = [0]
    inner = getattr(engine, method)

    def wrapped(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    setattr(engine, method, wrapped)
    return calls


def record_margins(engine) -> dict:
    """Record, for each host-sampled token of ``engine``, the top-2 margin
    of the logits it was drawn from, keyed by (rid, position)."""
    margins = {}
    inner = engine._sample_task_row

    def wrapped(logits_row, task, pos):
        top2 = np.partition(logits_row, -2)[-2:]
        margins[(task.rid, pos)] = float(abs(top2[1] - top2[0]))
        return inner(logits_row, task, pos)

    engine._sample_task_row = wrapped
    return margins


def decode_tick_breakdown(engine, vocab: int, n_ticks: int = 8) -> dict:
    """Where a decode tick's time goes with every slot busy: 8 requests of
    512 prompt tokens are admitted, then ``n_ticks`` decode-only ticks are
    timed by the host clock (a tick ends in the copy of the tokens to the
    host) and ``n_ticks`` more are traced by ``torch.profiler``."""
    rng = np.random.RandomState(2)
    for i in range(LM_SLOTS):
        engine.submit(Request(
            prompt=[int(t) for t in rng.randint(1, vocab // 2, size=512)],
            max_new_tokens=4 * n_ticks + 4, rid=1000 + i))
    engine.tick()                                 # admission + first step
    walls = []
    for _ in range(n_ticks):
        t0 = time.perf_counter()
        engine.tick()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    out = {"tick_wall_ms": walls[len(walls) // 2]}
    kernels, host = profile_ms(engine.tick, n_ticks)
    busy = sum(kernels.values())
    out["device_busy_ms"] = busy if busy > 0 else None
    out["device_idle_share_of_tick"] = (
        max(0.0, 1.0 - busy / out["tick_wall_ms"]) if busy > 0 else None)
    out["device_ms_by_kernel"] = dict(
        sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    out["host_self_ms"] = sum(host.values())
    out["host_ms_by_op"] = dict(
        sorted(host.items(), key=lambda kv: -kv[1])[:12])
    engine.run_until_idle()
    return out


def phase_serve_lm() -> dict:
    """Full-width llama3.2-1b through ServeEngine: the kernel path
    (flash_attention in prefill, decode_attention and fused_sampling in
    every decode tick) against the plain path (chunked attention, host
    sampling) on the same parameters and requests."""
    cfg = dataclasses.replace(cfg_lib.get_config(LM_ARCH), attn_impl="cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, DEVICE)            # drawn on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    kern = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       decode_kernel=True, device=DEVICE)
    plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"), params,
                        n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=DEVICE)
    del params
    reqs = lm_requests(cfg.vocab)

    # warm-up outside the engines' stats: a short generate() through each
    # path (cuBLAS handles, the kernels' first launches)
    for eng in (kern, plain):
        eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)

    groups = count_calls(kern, "_prefill_group")
    ticks = count_calls(kern, "_step")
    reset_counts()
    done = kern.serve(fresh(reqs))
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    stats = kern.stats()
    n_groups, n_ticks = groups[0], ticks[0]
    if len(done) != LM_REQUESTS:
        fail(f"serve_lm: {len(done)} of {LM_REQUESTS} requests completed")
    want = {"flash_attention": cfg.n_layers * n_groups,
            "decode_attention": cfg.n_layers * n_ticks,
            "fused_sampling": n_ticks}
    for name, n in want.items():
        if counts[name] != n or n < 1:
            fail(f"serve_lm: {name} launched {counts[name]} times, expected "
                 f"{n} ({n_groups} prefill groups, {n_ticks} decode ticks)")

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    again = kern.serve(fresh(reqs))
    tok = {c.rid: c.tokens for c in done}
    tok_plain = {c.rid: c.tokens for c in done_plain}
    tok_again = {c.rid: c.tokens for c in again}
    compared = ambiguous = 0
    first_diff = {}
    for r in reqs:
        a, b = tok[r.rid], tok_plain[r.rid]
        if len(a) != len(r.prompt) + LM_MAX_NEW:
            fail(f"serve_lm: rid {r.rid} has {len(a) - len(r.prompt)} new "
                 f"tokens")
        if min(a) < 0 or max(a) >= cfg.vocab:
            fail(f"serve_lm: rid {r.rid} has a token outside the vocabulary")
        if r.temperature > 0:
            if a != tok_again[r.rid]:
                fail(f"serve_lm: seeded rid {r.rid} differs between two runs "
                     f"of the kernel engine")
            continue
        for j in range(len(r.prompt), len(a)):
            compared += 1
            if a[j] == b[j]:
                continue
            m = margins[(r.rid, j)]
            if m >= LM_MARGIN:
                fail(f"serve_lm: rid {r.rid} token {j} differs from the plain "
                     f"path at a top-2 margin of {m} >= {LM_MARGIN}")
            ambiguous += 1
            first_diff[r.rid] = {"position": j, "margin": m}
            break                         # the sequences part ways here

    breakdown = decode_tick_breakdown(kern, cfg.vocab)
    lat = stats.latency_summary()
    emit("serve_lm", arch=LM_ARCH, params=n_params, init_s=init_s,
         slots=LM_SLOTS, max_len=LM_MAX_LEN, requests=stats.completed,
         new_tokens=stats.items, ticks=stats.ticks, prefill_groups=n_groups,
         decode_ticks=n_ticks, tok_per_s=stats.throughput,
         ms_per_tick=stats.ms_per_tick,
         latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                     for k, (n, p50, p95) in lat.items()},
         launches={k: counts[k] for k in want},
         greedy_tokens_compared=compared,
         ambiguous_positions=ambiguous, margin=LM_MARGIN,
         first_divergence=first_diff,
         seeded_bit_identical=True, **breakdown)
    return {k: counts[k] for k in want}


def flash_bound(case):
    """Causal attention: 4 * B * H * D operations per unmasked (i, t) pair
    (QK and PV, a multiply and an add each) at the bf16 tensor-core peak;
    q, k, v read and the output written once."""
    b, s, t, h, k, d = case["dims"]
    pairs = s * (s + 1) // 2 if case.get("causal", True) else s * t
    nbytes = 2 * (2 * b * s * h * d + 2 * b * t * k * d)
    return nbytes / HBM_BYTES_PER_S, 4 * b * h * d * pairs / BF16_FLOP_PER_S


def decode_bound(case):
    """The valid cache rows of K and V read once (bf16), q read and the
    output written once; 4 * H * D operations per valid row."""
    b, t, h, k, d = case["dims"]
    rows = sum(min(max(v, 0), t) for v in case["valid"])
    nbytes = 2 * (2 * rows * k * d + 2 * b * h * d) + 4 * b
    return nbytes / HBM_BYTES_PER_S, 4 * rows * h * d / BF16_FLOP_PER_S


def sampling_bound(case):
    """One read of the logits.  Operations per element, as this case's rows
    need them: the argmax (1); for a row with temperature > 0 also the
    division and the range (3), the hash, the two logarithms and the keep
    test of the draw (about 25), a compare and an add per top-k bisection
    step (60) when 0 < top_k < V, and the exponential, division and sum
    (3) plus a compare and an add per top-p step (60) when top_p < 1."""
    b, v = case["dims"]
    ops = 0
    for i in range(b):
        ops += 1
        if case.get("temperature", (1.0,) * b)[i] > 0:
            ops += 3 + 25
            if 0 < case.get("top_k", (0,) * b)[i] < v:
                ops += 60
            if case.get("top_p", (1.0,) * b)[i] < 1.0:
                ops += 63
    return 4 * b * v / HBM_BYTES_PER_S, ops * v / FP32_FLOP_PER_S


def library_call(name, args, kwargs):
    """One PyTorch call that computes the same function, timed as a
    yardstick (the port never calls it), or None."""
    import torch.nn.functional as F

    if name == "flash_attention":
        q, k, v = (x.transpose(1, 2) for x in args)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs["causal"], enable_gqa=True)
    if name == "decode_attention":
        q, k, v, valid = args
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(k.shape[1], device=k.device)[None, :]
                < valid[:, None].long())[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    if name == "fused_sampling":
        logits = args[0]
        return lambda: torch.argmax(logits, dim=-1)
    return None


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


BOUNDS = {"fused_routing": lambda c: routing_bound(c["shape"]),
          "taylor_softmax": lambda c: softmax_bound(c["shape"]),
          "flash_attention": flash_bound,
          "decode_attention": decode_bound,
          "fused_sampling": sampling_bound}

# the name of each kernel's CUDA function, for its profiler events
KERNEL_EVENT = {"fused_routing": "fused_routing_kernel",
                "taylor_softmax": "taylor_softmax",
                "flash_attention": "flash_attention_kernel",
                "decode_attention": "decode_attention_kernel",
                "fused_sampling": "fused_sampling_kernel"}


def timing_row(name, case, n_profile: int = 20) -> dict:
    """Kernel time by CUDA events (``ms``, wrapper included), the kernel
    alone by profiler events (``kernel_ms``), the plain version's and the
    library call's time, and the bound, at one case."""
    spec = registry.get(name)
    args, kwargs = spec.make_example(case, device=DEVICE)
    cfg = registry.default_config(name, *args, **kwargs)
    wrapper = spec.build()

    def call():
        return wrapper(*args, **kwargs, **cfg)

    plain = PLAIN.get(name)
    plain_call = ((lambda: plain(*args, **kwargs)) if plain
                  else (lambda: spec.ref_call(*args, **kwargs)))
    ms = median_ms(call)
    per_kernel = kernel_device_ms(call, n_profile)
    kernel_ms = sum(v for k, v in per_kernel.items()
                    if KERNEL_EVENT[name] in k) or None
    lib = library_call(name, args, kwargs)
    t_bytes, t_ops = BOUNDS[name](case)
    return {"ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": median_ms(plain_call, launches=5, repeats=3),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": median_ms(lib) if lib is not None else None,
            "shape": case_shape(case), "config": cfg}


def phase_timings(launches: dict, worst: dict) -> list:
    table = []
    vocab = cfg_lib.get_config(LM_ARCH).vocab
    valid = tuple(len(r.prompt) + 16 for r in lm_requests(vocab)[:LM_SLOTS])
    for name, info in KERNELS.items():
        case = dict(info["main_case"])
        if name == "decode_attention":
            case["valid"] = valid
        row = {"name": name, "route": info["route"], "source": info["source"],
               "replaces": info["replaces"], "launches": launches[name],
               "max_abs_err": worst[name], **timing_row(name, case)}
        table.append(row)
        emit("timings", **row)
    # the serve mix's sampling rows (temperature 0.8, top-k 50, top-p 0.9)
    case = {"dims": (LM_SLOTS, 128256), **MIXED}
    emit("timings", name="fused_sampling", case="mixed",
         **{k: v for k, v in timing_row("fused_sampling", case).items()
            if k != "library_ms"})
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
    launches_lm = phase_serve_lm()
    for name, n in {**launches, **{f"{k} (dense)": v
                                   for k, v in launches_dense.items()},
                    **launches_lm}.items():
        if n < 1:
            fail(f"{name} was never launched on the serve path")
    launches.update(launches_lm)
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

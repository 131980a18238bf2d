"""Serving launcher: LM decode or batched CapsNet image inference, both
through the ``repro_torch.serving`` engine API
(``submit() / poll() / run_until_idle() / stats()``).

    # LM at the published size on the card, every kernel of the path:
    # flash_attention (prefill), decode_attention and fused_sampling
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --no-reduced --decode-kernel --attn-impl cuda --requests 8

    # LM, smoke-sized, on the host (the kernels' plain versions); the moe,
    # vlm, ssm and hybrid families too (--arch deepseek-moe-16b |
    # dbrx-132b | llama-3.2-vision-90b | xlstm-1.3b | zamba2-1.2b; the
    # recurrent two are admitted in exact-length groups and cannot be
    # --paged).  hubert-xlarge is an encoder: the launcher refuses it.
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 3 --max-new 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --decode-kernel --attn-impl cuda --device cpu

    # LM, paged KV cache: global page pool + per-slot page tables,
    # content-addressed prefix reuse, int8 pages; decode reads the pages
    # in place through the decode_attention kernel (drop --device cpu and
    # add --no-reduced for the published size on the card)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --paged --quantize-pages --decode-kernel --attn-impl cuda \
        --device cpu

    # the paper's deployment path at the published size, on the card:
    # FastCapsPipeline -> DeployedCapsNet.serve(), FPS report
    PYTHONPATH=src python -m repro_torch.launch.serve --arch capsnet-mnist \
        --no-reduced --routing cuda --requests 8 --batch 32

    # SLO-scheduled, smoke-sized, on the host
    PYTHONPATH=src python -m repro_torch.launch.serve --arch capsnet-mnist \
        --requests 8 --batch 16 --routing optimized --scheduler slo \
        --slo-ms 50 --device cpu

    # LM, disaggregated: a prefill engine and 2 decode engines joined by
    # cache handoffs over a transport (add --paged [--quantize-pages] for
    # page handoffs with prefix dedup; drop --device cpu and add
    # --no-reduced for the published size on the card)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --scheduler disagg --decode-engines 2 --transport host_staged \
        --decode-kernel --attn-impl cuda --device cpu

    # CapsNet, disaggregated: a stateless load balancer over 2 engines
    PYTHONPATH=src python -m repro_torch.launch.serve --arch capsnet-mnist \
        --scheduler disagg --decode-engines 2 --device cpu

    # Traffic replay: seeded bursty arrivals against an autoscaled
    # disaggregated pool, with priority preemption + SLO admission
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --trace bursty --autoscale --priority --admission \
        --trace-rate 30 --trace-horizon 2 --decode-engines 3 --device cpu

The first call on the card builds the CUDA kernels into ``build/``.  At
``--no-reduced`` on the card the launcher refuses, before it draws a
weight, a model whose parameters (in ``param_dtype``, plus the engine's
compute-type copy) and slot caches exceed the card's free memory, and
names both numbers (a float32 deepseek-moe-16b needs about 101 GB; the
float32 recurrent state of xlstm-1.3b is 5.66 GB at 8 slots).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from repro_torch import configs as cfg_lib
from repro_torch.serving import (DisaggregatedEngine, FIFOScheduler,
                                 ImageRequest, InterleavingScheduler,
                                 PriorityScheduler, SLOBatchScheduler)


def _make_scheduler(args):
    if args.scheduler == "slo":
        return SLOBatchScheduler(target_p95_ms=args.slo_ms)
    if args.scheduler == "interleave":
        return InterleavingScheduler()
    if args.priority:
        return PriorityScheduler()
    return FIFOScheduler()


def _paged_kwargs(args) -> dict:
    """Page-pool engine kwargs from the CLI flags."""
    if not args.paged:
        return {}
    return dict(page_size=args.page_size, n_pages=args.pages,
                quantize_pages=args.quantize_pages)


def _print_pages(stats) -> None:
    if stats.pages:
        summary = " ".join(f"{k}={v}" for k, v in
                           sorted(stats.pages.items()))
        print(f"  pages: {summary}")


def _print_latency(stats) -> None:
    for cls, (n, p50, p95) in stats.latency_summary().items():
        print(f"  latency[{cls}]: n={n} p50={p50:.1f} ms p95={p95:.1f} ms")
    for phase, (n, p50, p95, peak) in stats.depth_summary().items():
        print(f"  depth[{phase}]: ticks={n} p50={p50:.0f} p95={p95:.0f} "
              f"peak={peak}")
    for stage, (n, p50, p95) in stats.transfer_summary().items():
        print(f"  transfer[{stage}]: n={n} p50={p50:.2f} ms "
              f"p95={p95:.2f} ms")


def _print_scale_events(events) -> None:
    if not events:
        print("  autoscale: no scale events")
        return
    for e in events:
        print(f"  autoscale[{e.action}]: t={e.t:.3f}s -> "
              f"{e.n_live} live engine(s)")


def param_bytes_served(cfg) -> int:
    """Bytes an engine holds for ``cfg``'s parameters: the parameters in
    ``param_dtype`` plus, when the compute type differs, the one
    compute-type copy ``ServeEngine`` casts (``lm.compute_params``)."""
    import torch

    from repro_torch.models import lm

    n = lm.param_bytes(cfg)
    if cfg.param_dtype == cfg.compute_dtype:
        return n
    size = torch.empty((), dtype=cfg.pdtype()).element_size()
    return n + n // size * torch.empty((), dtype=cfg.cdtype()).element_size()


def check_fits(cfg, free_bytes: int, n_slots: int = 0,
               max_len: int = 0) -> None:
    """Exit, naming both numbers, when ``cfg``'s served parameters and an
    engine's ``n_slots`` x ``max_len`` caches (KV and recurrent state,
    ``lm.cache_nbytes``) do not fit in ``free_bytes`` of device memory."""
    from repro_torch.models import lm

    need = param_bytes_served(cfg)
    if n_slots:
        need += lm.cache_nbytes(cfg, n_slots, max_len)
    if need > free_bytes:
        sys.exit(f"{cfg.arch_id}: the parameters and caches need {need:,} "
                 f"bytes on the card ({cfg.param_dtype}, plus the engine's "
                 f"{cfg.compute_dtype} copy), more than the {free_bytes:,} "
                 f"bytes torch.cuda.mem_get_info() reports free; serve it "
                 f"--reduced or on a card with more memory")


def _init_lm(args):
    """(cfg, params, device): the LM config with the chosen prefill
    attention, random weights from seed 0 drawn on the device (after a
    check that they fit there)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    cfg = cfg_lib.get_config(args.arch)
    if args.reduced:
        cfg = cfg_lib.reduced(cfg)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch has no decode path")
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    device = resolve_device(args.device)
    if device.type == "cuda":
        check_fits(cfg, torch.cuda.mem_get_info(device)[0], args.slots,
                   args.max_len)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return cfg, lm.init(cfg, gen, device), device


def _lm_engine_kwargs(args, device) -> dict:
    """Per-engine kwargs every LM engine of the launcher shares."""
    return dict(n_slots=args.slots, max_len=args.max_len,
                decode_kernel=args.decode_kernel, device=device,
                **_paged_kwargs(args))


def serve_traffic(args) -> None:
    """Replay a seeded arrival trace (``--trace poisson|bursty``) against
    an LM engine — optionally a disaggregated pool with closed-loop
    autoscaling (``--autoscale``), priority preemption (``--priority``)
    and SLO admission control (``--admission``)."""
    from repro_torch.serving import (DecodeEngine, ServeEngine,
                                     disaggregated_lm_engine)
    from repro_torch.traffic import (AutoscaleController, SLOAdmission,
                                     bursty_trace, default_classes,
                                     default_factory, poisson_trace, replay)

    cfg, params, device = _init_lm(args)
    classes = default_classes()
    if args.trace == "bursty":
        trace = bursty_trace(classes, rates=[args.trace_rate / 6,
                                             args.trace_rate],
                             dwell=[0.4, 0.2], horizon=args.trace_horizon,
                             seed=args.trace_seed)
    else:
        trace = poisson_trace(classes, rate=args.trace_rate,
                              horizon=args.trace_horizon,
                              seed=args.trace_seed)

    kw = _lm_engine_kwargs(args, device)
    controller = None
    if args.autoscale:
        def mk():
            return DecodeEngine(
                cfg, params, scheduler=PriorityScheduler()
                if args.priority else None, **kw)
        engine = disaggregated_lm_engine(
            cfg, params, n_decode=1, transport=args.transport,
            decode_schedulers=[PriorityScheduler()] if args.priority
            else None, **kw)
        controller = AutoscaleController(mk, min_engines=1,
                                         max_engines=args.decode_engines)
    elif args.scheduler == "disagg":
        engine = disaggregated_lm_engine(
            cfg, params, n_decode=args.decode_engines,
            transport=args.transport,
            decode_schedulers=[PriorityScheduler()
                               for _ in range(args.decode_engines)]
            if args.priority else None, **kw)
    else:
        engine = ServeEngine(cfg, params, scheduler=_make_scheduler(args),
                             **kw)
    admission = SLOAdmission() if args.admission else None

    rep = replay(engine, trace,
                 factory=default_factory(trace, vocab=cfg.vocab // 2),
                 controller=controller, admission=admission)

    stats = rep.stats
    print(f"[{cfg.arch_id}] on {device}: trace={args.trace} "
          f"seed={args.trace_seed}: {len(trace)} arrivals over "
          f"{trace.horizon:.1f}s ({trace.rate():.1f} req/s)")
    print(f"  submitted={rep.submitted} completed={rep.completed} "
          f"rejected={rep.rejected} dropped={rep.dropped} "
          f"preempted={stats.preempted}")
    if rep.dropped:
        raise RuntimeError(f"{rep.dropped} admitted request(s) dropped")
    print(f"  served {stats.items} new tokens in {stats.wall_s:.2f}s "
          f"({stats.throughput:.1f} tok/s, {stats.ms_per_tick:.1f} "
          f"ms/tick)")
    _print_latency(stats)
    _print_pages(stats)
    if controller is not None:
        _print_scale_events(rep.scale_events)
        if rep.mean_live_engines is not None:
            print(f"  autoscale: mean live engines = "
                  f"{rep.mean_live_engines:.2f} "
                  f"(max {args.decode_engines})")


def serve_lm(args) -> None:
    """Continuous-batching ragged prefill + decode through ServeEngine (or,
    with ``--scheduler disagg``, a prefill engine and ``--decode-engines``
    decode engines joined by cache handoffs over ``--transport``), random
    weights from seed 0."""
    from repro_torch.serving import (Request, ServeEngine,
                                     disaggregated_lm_engine)

    cfg, params, device = _init_lm(args)
    kw = _lm_engine_kwargs(args, device)
    if args.scheduler == "disagg":
        engine = disaggregated_lm_engine(
            cfg, params, n_decode=args.decode_engines,
            kernel_tune=args.kernel_tune or None,
            transport=args.transport, **kw)
    else:
        engine = ServeEngine(cfg, params, scheduler=_make_scheduler(args),
                             kernel_tune=args.kernel_tune or None, **kw)
    del params
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=list(rng.randint(1, cfg.vocab // 2,
                                            size=rng.randint(3, 9))),
                    max_new_tokens=args.max_new, rid=i, stream=args.stream)
            for i in range(args.requests)]
    if args.stream:
        # token-level results as they are generated (poll(stream=True))
        for r in reqs:
            engine.submit(r)
        completions = []
        while True:
            busy = engine.tick()
            for ev in engine.poll(stream=True):
                if ev.done:
                    completions.append(ev.completion)
                    print(f"  rid={ev.rid}: done")
                else:
                    print(f"  rid={ev.rid} #{ev.seq}: token {ev.item}")
            if not busy and engine.n_pending == 0:
                break
        engine.poll()                      # drain the completion channel
    else:
        completions = engine.serve(reqs)
    stats = engine.stats()
    # Completion.tokens includes the prompt; stats count generated tokens.
    print(f"[{cfg.arch_id}] on {device}: served {stats.completed} "
          f"requests ({stats.items} new tokens) in {stats.wall_s:.2f}s "
          f"({stats.throughput:.1f} tok/s, {stats.ms_per_tick:.1f} ms/tick)")
    _print_latency(stats)
    _print_pages(stats)
    for c in sorted(completions, key=lambda c: c.rid):
        print(f"  rid={c.rid}: latency={c.latency_s * 1e3:.0f} ms "
              f"{c.tokens}")


def serve_capsnet(args) -> None:
    """The paper's deployment path: prune -> compact -> compile -> serve."""
    from repro_torch.deploy import FastCapsPipeline

    cfg = cfg_lib.get_config(args.arch)
    if args.reduced:
        cfg = cfg_lib.reduced(cfg)
    pipe = FastCapsPipeline(cfg, device=args.device).build(seed=0)
    if args.sparsity > 0:
        pipe.prune(args.sparsity, args.sparsity,
                   type_keep=max(cfg.caps_types // 4, 1)).compact()
    deployed = pipe.compile(routing=args.routing)
    print(f"[{cfg.arch_id}] deployed on {deployed.device}: "
          f"routing={deployed.spec.mode}"
          f"(softmax={deployed.spec.softmax}) "
          f"{deployed.n_params:,} params, "
          f"{deployed.flops_per_image / 1e6:.1f} MFLOP/image")

    if args.scheduler == "disagg":
        # stateless disaggregation: dispatch frames over an engine pool
        engine = DisaggregatedEngine(
            None, [deployed.serve(batch_size=args.batch,
                                  kernel_tune=args.kernel_tune or None)
                   for _ in range(args.decode_engines)])
    else:
        engine = deployed.serve(batch_size=args.batch,
                                scheduler=_make_scheduler(args),
                                kernel_tune=args.kernel_tune or None)
    engine.warmup()
    rng = np.random.RandomState(0)
    for i in range(args.requests):
        engine.submit(ImageRequest(
            images=rng.rand(rng.randint(1, 2 * args.batch),
                            cfg.image_hw, cfg.image_hw,
                            cfg.in_channels).astype(np.float32),
            rid=i))
    completions = engine.run_until_idle()
    stats = engine.stats()
    print(f"  served {stats.completed} requests / {stats.frames} frames "
          f"in {stats.batches} ticks ({stats.padded_frames} pad): "
          f"{stats.fps:.1f} FPS, {stats.ms_per_batch:.2f} ms/tick")
    _print_latency(stats)
    for c in sorted(completions, key=lambda c: c.rid):
        print(f"  rid={c.rid}: {len(c.classes)} frames, "
              f"latency={c.latency_s * 1e3:.1f} ms, "
              f"classes={c.classes[:8].tolist()}"
              f"{'...' if len(c.classes) > 8 else ''}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfg_lib.list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="smoke-sized config (--no-reduced for the "
                         "published size)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--scheduler", default="fifo",
                    choices=["fifo", "slo", "interleave", "disagg"],
                    help="tick scheduler (slo adapts batch to --slo-ms; "
                         "interleave separates prefill and decode ticks; "
                         "disagg splits prefill and decode onto separate "
                         "engines joined by cache handoffs)")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="SLO scheduler p95 tick-latency target")
    ap.add_argument("--decode-engines", type=int, default=2,
                    help="disagg: number of decode engines behind the "
                         "prefill engine (the CapsNet pool's size; with "
                         "--autoscale the pool's maximum)")
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "in_process", "host_staged",
                             "device_to_device"],
                    help="disagg: cache-handoff delivery route (auto picks "
                         "device_to_device when a decode engine's device "
                         "differs from the prefill engine's, in_process "
                         "otherwise: on one card, in_process)")
    ap.add_argument("--multihost", action="store_true",
                    help="disagg: prefill and decode engines on disjoint "
                         "device meshes (not ported yet)")
    ap.add_argument("--kernel-tune", action="store_true",
                    help="autotune the kernels' launch geometry (routing "
                         "at warm-up, flash attention per prefill bucket) "
                         "and serve with the winners")
    ap.add_argument("--priority", action="store_true",
                    help="PriorityScheduler: urgent classes admit first "
                         "and may preempt (lossless) resident work")
    # LM options
    ap.add_argument("--slots", type=int, default=4,
                    help="LM: KV-cache slots (continuous-batching width)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="LM: cache length per slot")
    ap.add_argument("--max-new", type=int, default=12,
                    help="LM: tokens to generate per request")
    ap.add_argument("--paged", action="store_true",
                    help="LM: block-paged KV cache (global page pool + "
                         "per-slot page tables) with content-addressed "
                         "prefix reuse across requests")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged: tokens per cache page")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged: total pool pages (default sizes the "
                         "pool to n_slots * max_len tokens)")
    ap.add_argument("--quantize-pages", action="store_true",
                    help="paged: store KV pages as int8 with per-row "
                         "scales, dequantized on read")
    ap.add_argument("--stream", action="store_true",
                    help="LM: print token-level StreamEvents as they are "
                         "generated (poll(stream=True))")
    ap.add_argument("--decode-kernel", action="store_true",
                    help="LM: decode through the decode_attention kernel "
                         "(paged caches read in place through the page "
                         "tables, int8 pages dequantized on read) and draw "
                         "tokens on the card with fused_sampling")
    ap.add_argument("--attn-impl", default="chunked",
                    choices=["chunked", "cuda"],
                    help="LM: prefill attention (cuda = the flash_attention "
                         "kernel)")
    # Traffic-replay options
    ap.add_argument("--trace", default="none",
                    choices=["none", "poisson", "bursty"],
                    help="replay a seeded arrival trace instead of a fixed "
                         "request batch (LM only)")
    ap.add_argument("--trace-rate", type=float, default=20.0,
                    help="mean arrival rate (req/s); bursty uses it as the "
                         "burst-state rate")
    ap.add_argument("--trace-horizon", type=float, default=2.0,
                    help="trace length in seconds")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="trace RNG seed (same seed -> same arrivals and "
                         "payloads)")
    ap.add_argument("--autoscale", action="store_true",
                    help="traffic: start one decode engine and let the "
                         "depth-signal controller grow/drain the pool up "
                         "to --decode-engines")
    ap.add_argument("--admission", action="store_true",
                    help="traffic: SLO admission control (shed arrivals "
                         "whose class SLO is already unattainable)")
    # CapsNet options
    ap.add_argument("--batch", type=int, default=16,
                    help="CapsuleEngine capacity (max frames per tick)")
    ap.add_argument("--routing", default="cuda",
                    choices=["reference", "optimized", "cuda"])
    ap.add_argument("--sparsity", type=float, default=0.6,
                    help="LAKP sparsity for both conv layers (0 = dense)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises when no card "
                         "is present")
    args = ap.parse_args(argv)
    if args.multihost:
        if args.scheduler != "disagg":
            ap.error("--multihost requires --scheduler disagg")
        ap.exit(2, "--multihost: prefill and decode engines on disjoint "
                   "device meshes need the sharding slice, which is not "
                   "ported yet; see ROADMAP.md, queue A item 5\n")
    if args.paged and args.arch in cfg_lib.PAPER_ARCHS:
        ap.error("--paged applies to LM serving only")
    if args.arch in cfg_lib.PAPER_ARCHS:
        if args.trace != "none":
            ap.error("--trace applies to LM serving only")
        serve_capsnet(args)
    elif args.trace != "none":
        serve_traffic(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()

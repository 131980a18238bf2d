"""Serving launcher: LM decode or batched CapsNet image inference, both
through the ``repro_torch.serving`` engine API
(``submit() / poll() / run_until_idle() / stats()``).

    # LM at the published size on the card, every kernel of the path:
    # flash_attention (prefill), decode_attention and fused_sampling
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --no-reduced --decode-kernel --attn-impl cuda --requests 8

    # LM, smoke-sized, on the host (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 3 --max-new 4 --device cpu

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

The first call on the card builds the CUDA kernels into ``build/``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import configs as cfg_lib
from repro_torch.serving import (FIFOScheduler, ImageRequest,
                                 InterleavingScheduler, PriorityScheduler,
                                 SLOBatchScheduler)


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


def serve_lm(args) -> None:
    """Continuous-batching ragged prefill + decode through ServeEngine,
    random weights from seed 0."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serving import Request, ServeEngine

    cfg = cfg_lib.get_config(args.arch)
    if args.reduced:
        cfg = cfg_lib.reduced(cfg)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device)
    engine = ServeEngine(cfg, params, n_slots=args.slots,
                         max_len=args.max_len,
                         scheduler=_make_scheduler(args),
                         kernel_tune=args.kernel_tune or None,
                         decode_kernel=args.decode_kernel, device=device,
                         **_paged_kwargs(args))
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
    print(f"[{cfg.arch_id}] on {engine.device}: served {stats.completed} "
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
                    choices=["fifo", "slo", "interleave"],
                    help="tick scheduler (slo adapts batch to --slo-ms; "
                         "interleave separates prefill and decode ticks)")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="SLO scheduler p95 tick-latency target")
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
    if args.paged and args.arch in cfg_lib.PAPER_ARCHS:
        ap.error("--paged applies to LM serving only")
    if args.arch in cfg_lib.PAPER_ARCHS:
        serve_capsnet(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()

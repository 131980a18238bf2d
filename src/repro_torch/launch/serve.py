"""Serving launcher: batched CapsNet image inference through the
``repro_torch.serving`` engine API
(``submit() / poll() / run_until_idle() / stats()``).

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

import numpy as np

from repro_torch import configs as cfg_lib
from repro_torch.serving import (FIFOScheduler, ImageRequest,
                                 PriorityScheduler, SLOBatchScheduler)


def _make_scheduler(args):
    if args.scheduler == "slo":
        return SLOBatchScheduler(target_p95_ms=args.slo_ms)
    if args.priority:
        return PriorityScheduler()
    return FIFOScheduler()


def _print_latency(stats) -> None:
    for cls, (n, p50, p95) in stats.latency_summary().items():
        print(f"  latency[{cls}]: n={n} p50={p50:.1f} ms p95={p95:.1f} ms")
    for phase, (n, p50, p95, peak) in stats.depth_summary().items():
        print(f"  depth[{phase}]: ticks={n} p50={p50:.0f} p95={p95:.0f} "
              f"peak={peak}")


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
    ap.add_argument("--scheduler", default="fifo", choices=["fifo", "slo"],
                    help="tick scheduler (slo adapts batch to --slo-ms)")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="SLO scheduler p95 tick-latency target")
    ap.add_argument("--kernel-tune", action="store_true",
                    help="autotune the routing kernel's launch geometry at "
                         "warm-up and serve with the winners")
    ap.add_argument("--priority", action="store_true",
                    help="PriorityScheduler: urgent classes admit first")
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
    serve_capsnet(args)


if __name__ == "__main__":
    main()

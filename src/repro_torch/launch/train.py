"""Training launcher: any registered architecture, end to end on the card.

    # the paper's model at its published size, on the card: train, LAKP
    # prune, masked fine-tune, compact, and evaluate through the routing
    # kernel
    PYTHONPATH=src python -m repro_torch.launch.train --arch capsnet-mnist \\
        --steps 300 --batch 32 --n-train 2048 --n-test 512 \\
        --prune lakp:0.9 --finetune-steps 100

    # an LM on the synthetic token stream, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 30 --batch 8 --seq 512

    # reduced configs on the host (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train --arch capsnet-mnist \\
        --reduced --steps 8 --prune lakp:0.7 --finetune-steps 4 \\
        --n-train 64 --n-test 32 --batch 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 4 --device cpu

CapsNet training runs through the config's routing spec (``reference`` for
both CapsNets; ``optimized`` trains too, its Eq. 2 softmax differentiated
by the ``taylor_softmax_bwd`` kernel, and the fused routing kernel has no
backward).  The compacted model is
compiled twice, with the config's spec and with ``cuda`` (the hand-written
routing kernel), and both are evaluated.  An LM trains with ``lm.loss_fn``
through its config's ``attn_impl`` (``chunked``: the attention kernels have
no backward either), the port's ``Trainer`` and functional AdamW, on the
token stream of ``repro_torch.data.tokens``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs as cfg_lib
from repro_torch.core import capsnet as capsnet_lib
from repro_torch.core import pruning as pruning_lib
from repro_torch.data import synthetic_digits, tokens
from repro_torch.deploy import FastCapsPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.training import Trainer, TrainerConfig


def accuracy(classify: Callable[[torch.Tensor], torch.Tensor],
             x: np.ndarray, y: np.ndarray, device: torch.device,
             batch: int = 256) -> float:
    """Share of ``x`` that ``classify`` (images on ``device`` -> class ids)
    gets right, in slices of ``batch`` images."""
    right = 0
    with torch.no_grad():
        for i in range(0, len(x), batch):
            xb = torch.from_numpy(x[i:i + batch]).to(device)
            right += int((classify(xb).cpu().numpy() == y[i:i + batch]).sum())
    return right / len(x)


def train_lm(args) -> None:
    device = resolve_device(args.device)
    cfg = cfg_lib.get_config(args.arch)
    if args.reduced:
        cfg = cfg_lib.reduced(cfg)
    stream = tokens.TokenStream(tokens.TokenStreamConfig(vocab=cfg.vocab))
    tcfg = TrainerConfig(
        optim=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every)
    trainer = Trainer(tcfg, lambda p, b: lm.loss_fn(p, cfg, b),
                      lambda g: lm.init(cfg, g, device), device=device)
    t0 = time.time()
    res = trainer.run(stream.batches(args.batch, args.seq, args.steps),
                      args.steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"[{cfg.arch_id}] {res.step} steps in {dt:.1f}s "
          f"({res.step / dt:.2f} steps/s) on {device}")
    for h in res.history:
        print("  ", {k: round(v, 4) for k, v in h.items()})


def train_capsnet(args) -> None:
    device = resolve_device(args.device)
    cfg = cfg_lib.get_config(args.arch)
    if args.reduced:
        cfg = cfg_lib.reduced(cfg)
    variant = "fashion" if "fmnist" in args.arch else "digits"
    data = synthetic_digits.load(synthetic_digits.DigitsConfig(
        variant=variant, n_train=args.n_train, n_test=args.n_test))
    tr_x, tr_y = data["train"]
    te_x, te_y = data["test"]

    def loss_fn(p, b):
        return capsnet_lib.loss_fn(p, cfg, b["images"], b["labels"])

    def batches(seed=0):
        for bx, by in synthetic_digits.batches(tr_x, tr_y, args.batch, seed,
                                               epochs=1000):
            yield {"images": bx, "labels": by}

    tcfg = TrainerConfig(
        optim=AdamWConfig(lr=args.lr, weight_decay=0.0,
                          warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every)
    trainer = Trainer(tcfg, loss_fn,
                      lambda g: capsnet_lib.init(cfg, g, device),
                      device=device)
    res = trainer.run(batches(), args.steps)
    print(f"[{cfg.arch_id}] trained {res.step} steps on {device}; "
          f"final: {res.history[-1] if res.history else {}}")

    def forward_classes(params, c):
        return lambda x: torch.argmax(capsnet_lib.forward(params, c, x)[0],
                                      dim=-1)

    acc = accuracy(forward_classes(res.params, cfg), te_x, te_y, device)
    print(f"  test acc (dense): {acc:.4f}")

    if not args.prune:
        return
    method, rate = args.prune.split(":")
    rate = float(rate)

    def finetune(masked, masks):
        ft = Trainer(
            TrainerConfig(optim=AdamWConfig(
                lr=args.lr / 3, weight_decay=0.0,
                warmup_steps=1, total_steps=args.finetune_steps)),
            loss_fn, lambda g: masked,
            mask_fn=lambda g: pruning_lib.mask_gradients(g, masks),
            device=device)
        return ft.run(batches(), args.finetune_steps).params

    pipe = FastCapsPipeline(cfg, params=res.params, device=device)
    pipe.prune(rate, rate, method=method).finetune(finetune)
    acc_p = accuracy(forward_classes(pipe.params, pipe.cfg), te_x, te_y,
                     device)
    pipe.compact()
    c_cfg = pipe.cfg
    print(f"  pruned[{method}:{rate}] compression={pipe.compression:.4f} "
          f"index_overhead={pipe.index_overhead_frac:.5f}")
    print(f"  test acc (pruned+finetuned): {acc_p:.4f}; compacted "
          f"({c_cfg.caps_types}/{cfg.caps_types} capsule types, "
          f"{c_cfg.n_primary_caps} capsules):")
    for routing in (None, "cuda"):
        deployed = pipe.compile(routing=routing)
        acc_c = accuracy(deployed.classify, te_x, te_y, device)
        print(f"    routing {deployed.spec.mode}: {acc_c:.4f} "
              f"({deployed.n_params:,} params)")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=cfg_lib.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    # capsnet options
    ap.add_argument("--prune", default=None, help="lakp:0.97 | kp:0.97")
    ap.add_argument("--finetune-steps", type=int, default=50)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where to run (default: the card; raises when "
                         "there is none)")
    args = ap.parse_args(argv)
    if args.arch.startswith("capsnet"):
        train_capsnet(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()

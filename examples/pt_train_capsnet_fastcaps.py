"""End-to-end FastCaps run on the PyTorch port (``repro_torch``): train
a CapsNet on the synthetic digit set, run the full Fig. 6 methodology
(LAKP prune -> masked fine-tune -> compact) through ``FastCapsPipeline``,
compile the ``DeployedCapsNet``, and serve the test set through
``CapsuleEngine`` — reporting accuracy, compression, and served FPS.

    PYTHONPATH=src python examples/pt_train_capsnet_fastcaps.py
    PYTHONPATH=src python examples/pt_train_capsnet_fastcaps.py --steps 300
    PYTHONPATH=src python examples/pt_train_capsnet_fastcaps.py --device cpu

Training runs through the reference routing (the kernels have no
backward); the deployed model routes through ``--routing`` (default
``cuda``, the hand-written kernel on the card).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import capsnet as cn
from repro_torch.core import pruning as pr
from repro_torch.data import synthetic_digits as sd
from repro_torch.deploy import FastCapsPipeline
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.serving import CapsuleEngine, ImageRequest
from repro_torch.training import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--finetune-steps", type=int, default=80)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--routing", default="cuda",
                    choices=["reference", "optimized", "cuda"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the card (raises when there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = cn.CapsNetConfig(arch_id="fastcaps-demo", conv1_channels=16,
                           caps_types=4, decoder_hidden=(32, 64))
    data = sd.load(sd.DigitsConfig(n_train=args.n_train, n_test=256))
    tr_x, tr_y = data["train"]
    te_x, te_y = data["test"]

    def loss_fn(p, b):
        return cn.loss_fn(p, cfg, b["images"], b["labels"])

    def batches(seed=0):
        for bx, by in sd.batches(tr_x, tr_y, 32, seed, epochs=1000):
            yield {"images": bx, "labels": by}

    # 1. train dense
    tcfg = TrainerConfig(
        optim=AdamWConfig(lr=1e-3, weight_decay=0.0,
                          warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        log_every=max(args.steps // 4, 1))
    res = Trainer(tcfg, loss_fn, lambda g: cn.init(cfg, g, device),
                  device=device).run(batches(), args.steps)
    print(f"[{cfg.arch_id}] trained {res.step} steps on {device}; "
          f"final: {res.history[-1] if res.history else {}}")

    # 2. FastCapsPipeline: prune -> masked fine-tune -> compact -> compile
    def finetune(masked, masks):
        ft = Trainer(
            TrainerConfig(optim=AdamWConfig(
                lr=3e-4, weight_decay=0.0, warmup_steps=1,
                total_steps=args.finetune_steps)),
            loss_fn, lambda g: masked,
            mask_fn=lambda g: pr.mask_gradients(g, masks), device=device)
        return ft.run(batches(seed=7), args.finetune_steps).params

    pipe = FastCapsPipeline(cfg, params=res.params, device=device)
    pipe.prune(args.sparsity, args.sparsity, method="lakp")
    pipe.finetune(finetune).compact()
    deployed = pipe.compile(routing=args.routing)
    print(f"  compression={pipe.compression:.4f} "
          f"({deployed.cfg.caps_types}/{cfg.caps_types} capsule types, "
          f"{deployed.cfg.n_primary_caps} capsules, "
          f"{deployed.n_params:,} params)")

    # 3. accuracy of the deployed artifact + served throughput
    classes = deployed.classify(torch.from_numpy(te_x).to(device))
    acc = float((classes.cpu().numpy() == te_y).mean())
    engine = CapsuleEngine(deployed, batch_size=args.batch, device=device)
    engine.warmup()
    rng = np.random.RandomState(0)
    cuts = np.sort(rng.choice(np.arange(1, len(te_x)), size=7,
                              replace=False))
    reqs = [ImageRequest(images=chunk, rid=i)
            for i, chunk in enumerate(np.split(te_x, cuts))]
    engine.serve(reqs)
    s = engine.stats()
    print(f"  deployed[{deployed.spec.mode}] test acc: {acc:.4f}; served "
          f"{s.frames} frames in {s.batches} batches: {s.fps:.1f} FPS")


if __name__ == "__main__":
    main()

"""Quickstart of the PyTorch port: the ``repro_torch.deploy`` pipeline in
~50 lines.

    PYTHONPATH=src python examples/pt_quickstart.py              # the card
    PYTHONPATH=src python examples/pt_quickstart.py --device cpu

``FastCapsPipeline`` carries a CapsNet through the paper's Fig. 6
methodology — ``build() -> prune() -> compact() -> compile()`` — and
returns an immutable ``DeployedCapsNet``.  Routing variants are typed
``RoutingSpec``s resolved through the deploy registry; ``cuda`` is the
hand-written routing kernel on the card (its plain version on a CPU
tensor), and ``deployed.serve(scheduler=...)`` hands the artifact to the
serving engine (``repro_torch.serving``).
"""

import argparse

import torch

from repro_torch.core import capsnet as cn
from repro_torch.deploy import FastCapsPipeline, RoutingSpec

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                help="default: the card (raises when there is none)")
device = ap.parse_args().device

# 1. a CapsNet pipeline (Sabour et al. architecture; small for the demo)
cfg = cn.CapsNetConfig(arch_id="quickstart", conv1_channels=32,
                       caps_types=8, decoder_hidden=(64, 128))
pipe = FastCapsPipeline(cfg, device=device).build(seed=0)
print(f"dense CapsNet: {cn.param_count(pipe.params):,} params, "
      f"{cfg.n_primary_caps} primary capsules")

# 2. LAKP prune (60% conv1 kernels, 90% conv2 kernels, keep 2/8 capsule
#    types) and physically compact the survivors
pipe.prune(sparsity_conv1=0.6, sparsity_conv2=0.9, method="lakp",
           type_keep=2).compact()
print(f"pruned: compression={pipe.compression:.2%}, "
      f"{pipe.cfg.n_primary_caps} capsules survive, "
      f"{cn.param_count(pipe.params):,} params, "
      f"index overhead={pipe.index_overhead_frac:.4%}")

# 3. FastCaps deployment: fused routing + Eq. 2 softmax in one kernel,
#    compiled against the reference deployment for the agreement check
dep_ref = pipe.compile(routing="reference")
dep_opt = pipe.compile(routing=RoutingSpec.cuda(softmax="taylor"))
gen = torch.Generator().manual_seed(1)
images = torch.rand((8, 28, 28, 1), generator=gen).to(dep_ref.device)
lengths_ref = dep_ref.forward(images)
lengths_opt = dep_opt.forward(images)
agree = float((lengths_ref.argmax(-1) == lengths_opt.argmax(-1))
              .float().mean())
print(f"cuda-vs-reference prediction agreement: {agree:.0%}")
print(f"max |Δ capsule length|: "
      f"{float((lengths_ref - lengths_opt).abs().max()):.2e}")

"""LAKP beyond CapsNet, in the port: structured look-ahead pruning of an
LM's FFN hidden blocks and attention-head groups, the paper's technique
generalized to the assigned architectures.

    PYTHONPATH=src python examples/pt_prune_lm.py                  # the card
    PYTHONPATH=src python examples/pt_prune_lm.py --device cpu
"""

import argparse

import torch

from repro_torch import configs as cfg_lib
from repro_torch.core import pruning as pr
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                help="default: the card (raises when there is none)")
device = resolve_device(ap.parse_args().device)

ARCH = "qwen3-1.7b"
cfg = cfg_lib.reduced(cfg_lib.get_config(ARCH))
gen = torch.Generator(device=device).manual_seed(0)
params = lm.init(cfg, gen, device)
stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab))
batch = {k: torch.from_numpy(v).to(device)
         for k, v in stream.sample(8, 64, seed=0).items()}

with torch.no_grad():
    loss0, _ = lm.loss_fn(params, cfg, batch)
print(f"[{ARCH} reduced] dense loss: {float(loss0):.4f} on {device}")

# prune 50% of FFN hidden blocks in every layer with look-ahead scores
units = params["units"]
ffn = units["block"]["ffn"]
n_layers = ffn["wi"].shape[0]
masks = []
layers = []
for layer in range(n_layers):
    layer_p = {k: ffn[k][layer] for k in ("wi", "wg", "wo")}
    pruned, mask = pr.prune_lm_ffn(layer_p, n_blocks=8, sparsity=0.5,
                                   method="lakp")
    layers.append(pruned)
    masks.append(mask)
ffn_p = dict(ffn, **{k: torch.stack([p[k] for p in layers])
                     for k in ("wi", "wg", "wo")})
params_p = dict(params)
params_p["units"] = dict(units, block=dict(units["block"], ffn=ffn_p))

with torch.no_grad():
    loss1, _ = lm.loss_fn(params_p, cfg, batch)
kept = sum(int(m.sum()) for m in masks)
print(f"pruned 50% FFN blocks ({kept}/{n_layers * 8} survive): "
      f"loss {float(loss1):.4f} (untrained net: loss should barely move)")

# attention-head pruning on one layer (KV-group granularity)
attn = {k: units["block"]["attn"][k][0] for k in ("wq", "wk", "wv", "wo")}
pruned_attn, head_mask = pr.prune_lm_heads(
    attn, cfg.n_heads, cfg.n_kv_heads, sparsity=0.5)
print(f"head pruning: {int(head_mask.sum())}/{cfg.n_kv_heads} KV groups "
      f"survive -> KV cache shrinks by "
      f"{(1 - float(head_mask.mean())):.0%} (the PrimaryCaps-elimination "
      f"analogue)")

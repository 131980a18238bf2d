"""Prune -> fine-tune -> compact pipeline (paper Fig. 6): the optimizer-facing
mask helper.

The methodology: (1) score + mask kernels with LAKP (or a baseline method),
(2) fine-tune the masked network (masked weights stay zero: gradients are
multiplied by the mask each step), (3) study interconnections and physically
eliminate dead kernels/capsules (``capsnet.compact``), (4) hand the compacted
model to the optimized-routing deployment path.

The canonical CapsNet entry point is ``repro_torch.deploy.FastCapsPipeline``;
this module keeps the mask helper its fine-tuning step needs.  The
LM-substrate structured pruning of ``repro.core.pruning`` comes with the LM
training slice.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core import lakp as lakp_lib


def mask_gradients(grads: Dict[str, Any], masks) -> Dict[str, Any]:
    """Keep pruned kernels at zero during fine-tuning: the conv gradients
    times their kernel masks (a new tree; ``grads`` is left as it was)."""
    m1, m2 = masks
    out = dict(grads)
    out["conv1"] = dict(grads["conv1"])
    out["conv2"] = dict(grads["conv2"])
    out["conv1"]["w"] = lakp_lib.apply_kernel_mask(grads["conv1"]["w"], m1)
    out["conv2"]["w"] = lakp_lib.apply_kernel_mask(grads["conv2"]["w"], m2)
    return out

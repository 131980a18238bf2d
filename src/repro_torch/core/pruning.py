"""Prune -> fine-tune -> compact pipeline (paper Fig. 6): the optimizer-facing
mask helper.

The methodology: (1) score + mask kernels with LAKP (or a baseline method),
(2) fine-tune the masked network (masked weights stay zero: gradients are
multiplied by the mask each step), (3) study interconnections and physically
eliminate dead kernels/capsules (``capsnet.compact``), (4) hand the compacted
model to the optimized-routing deployment path.

The same pipeline generalizes to the LM families: FFN hidden blocks,
attention-head groups and MoE experts are pruned with
``lakp.prune_blocks``-style block scores and compacted with
``lakp.compact_blocks``.

The canonical CapsNet entry point is ``repro_torch.deploy.FastCapsPipeline``;
this module keeps the mask helper its fine-tuning step needs and the
LM-substrate structured pruning of ``repro.core.pruning``.  Each pruning
function takes one layer's parameter dict and returns a new dict (the
input is left as it is) and the block mask.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

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


# ---------------------------------------------------------------------------
# LM-substrate structured pruning
# ---------------------------------------------------------------------------


def prune_lm_ffn(params: Dict[str, torch.Tensor], n_blocks: int,
                 sparsity: float, method: str = "lakp"
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Prune hidden blocks of one FFN param dict ({wi, wo[, wg]}); the gate
    ``wg`` loses the same hidden units as ``wi``."""
    w_in, w_out = params["wi"], params["wo"]
    wi2 = w_in.reshape(w_in.shape[0], -1)
    wo2 = w_out.reshape(w_out.shape[0], -1) if w_out.dim() == 2 else w_out
    wi_m, wo_m, mask = lakp_lib.prune_blocks(wi2, wo2, n_blocks, sparsity,
                                             method=method)
    out = dict(params)
    out["wi"], out["wo"] = wi_m.reshape(w_in.shape), wo_m.reshape(w_out.shape)
    if "wg" in params:
        m_f = torch.repeat_interleave(mask, w_in.shape[1] // n_blocks)
        out["wg"] = params["wg"] * m_f[None, :].to(params["wg"].dtype)
    return out, mask


def prune_lm_heads(params: Dict[str, torch.Tensor], n_heads: int,
                   n_kv_heads: int, sparsity: float, method: str = "lakp"
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Prune attention heads in KV-head groups, so GQA stays consistent.

    Scores: the look-ahead product of the group's Q-projection fan-in and
    O-projection fan-out (K and V belong to the group).  One mask entry is
    one KV group of ``n_heads / n_kv_heads`` query heads."""
    wq, wo = params["wq"], params["wo"]          # (d, H, hd), (H, hd, d)
    d, h, hd = wq.shape
    g = h // n_kv_heads
    wq2 = wq.reshape(d, h * hd)
    wo2 = wo.reshape(h * hd, d)
    if method == "lakp":
        scores = lakp_lib.block_lookahead_scores(wq2, wo2, n_kv_heads)
    else:
        scores = lakp_lib.block_magnitude_scores(wq2, wo2, n_kv_heads)
    mask = lakp_lib.mask_from_scores(scores, sparsity)    # (n_kv,)
    mq = torch.repeat_interleave(mask, g * hd).reshape(1, h, hd)
    mkv = torch.repeat_interleave(mask, hd).reshape(1, n_kv_heads, hd)
    out = dict(params)
    out["wq"] = wq * mq.to(wq.dtype)
    out["wk"] = params["wk"] * mkv.to(wq.dtype)
    out["wv"] = params["wv"] * mkv.to(wq.dtype)
    out["wo"] = wo * mq.reshape(h, hd, 1).to(wo.dtype)
    return out, mask


def prune_moe_experts(params: Dict[str, torch.Tensor], sparsity: float,
                      method: str = "lakp"
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Prune whole routed experts (the MoE analogue of capsule
    elimination).  An expert's score is the look-ahead product (``lakp``)
    or the sum (``kp``) of its input and output projections' L1 norms.  A
    pruned expert's weights are zeroed and the router's additive bias
    ``router_b`` suppresses it by ``(mask - 1) * 1e9``, so top-k never
    picks it (a weight-level offset would flip sign with negative
    activations)."""
    wi, wo = params["wi"], params["wo"]          # (E, d, f), (E, f, d)
    e = wi.shape[0]
    a = wi.abs().sum(dim=(1, 2))
    b = wo.abs().sum(dim=(1, 2))
    scores = a * b if method == "lakp" else a + b
    mask = lakp_lib.mask_from_scores(scores, sparsity)    # (E,)
    m3 = mask.reshape(e, 1, 1).to(wi.dtype)
    out = dict(params)
    out["wi"] = wi * m3
    out["wg"] = params["wg"] * m3
    out["wo"] = wo * m3
    rdt = params["router"].dtype
    bias = params.get("router_b")
    if bias is None:
        bias = torch.zeros((e,), dtype=rdt, device=wi.device)
    out["router_b"] = (bias + (mask - 1.0) * 1e9).to(rdt)
    return out, mask

"""Dense FFN blocks: SwiGLU (LLaMA-style) and the plain GELU MLP."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import (LMConfig, ParamDef, activation,
                                       fanin_init, fixed_matmul,
                                       fixed_order_route, zeros_init)


def mlp_defs(cfg: LMConfig, d_ff: int = 0) -> Dict[str, Any]:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    defs: Dict[str, Any] = {
        "wi": ParamDef((d, f), ("embed", "mlp"), fanin_init(d)),
        "wo": ParamDef((f, d), ("mlp", "embed_tp"), fanin_init(f)),
    }
    if cfg.glu:
        defs["wg"] = ParamDef((d, f), ("embed", "mlp"), fanin_init(d))
    if cfg.norm == "layernorm":  # encoder-style MLPs carry biases
        defs["bi"] = ParamDef((f,), ("mlp",), zeros_init())
        defs["bo"] = ParamDef((d,), (None,), zeros_init())
    return defs


def mlp_apply(params: Dict[str, torch.Tensor], cfg: LMConfig,
              x: torch.Tensor) -> torch.Tensor:
    """The FFN; its three products through the fixed-order GEMM on
    :func:`~repro_torch.models.common.fixed_order_route`."""
    cd = cfg.cdtype()
    act = activation(cfg.act)
    x = x.to(cd)
    wi = params["wi"].to(cd)
    mm = (fixed_matmul if fixed_order_route(cfg, x, wi)
          else torch.matmul)
    h = mm(x, wi)
    if "bi" in params:
        h = h + params["bi"].to(cd)
    if cfg.glu:
        h = act(mm(x, params["wg"].to(cd))) * h
    else:
        h = act(h)
    y = mm(h, params["wo"].to(cd))
    if "bo" in params:
        y = y + params["bo"].to(cd)
    return y

"""Dense FFN blocks: SwiGLU (LLaMA-style) and the plain GELU MLP."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import (LMConfig, ParamDef, activation,
                                       fanin_init, zeros_init)


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
    cd = cfg.cdtype()
    act = activation(cfg.act)
    h = x.to(cd) @ params["wi"].to(cd)
    if "bi" in params:
        h = h + params["bi"].to(cd)
    if cfg.glu:
        h = act(x.to(cd) @ params["wg"].to(cd)) * h
    else:
        h = act(h)
    y = h @ params["wo"].to(cd)
    if "bo" in params:
        y = y + params["bo"].to(cd)
    return y

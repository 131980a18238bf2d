"""Config registry of the port: the paper's two CapsNets and the dense LM
architectures served so far (llama3.2-1b, qwen3-1.7b).

``get_config(arch_id)`` returns the full published config;
``reduced(cfg)`` returns a CPU-smoke-sized config of the same family, by
the reference's rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.configs import (capsnet_fmnist, capsnet_mnist, llama3p2_1b,
                                 qwen3_1p7b)
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.models.common import LMConfig, MoEConfig, SSMConfig, XLSTMConfig

_MODULES = {
    "llama3.2-1b": llama3p2_1b,
    "qwen3-1.7b": qwen3_1p7b,
    "capsnet-mnist": capsnet_mnist,
    "capsnet-fmnist": capsnet_fmnist,
}

LM_ARCHS: List[str] = ["llama3.2-1b", "qwen3-1.7b"]
PAPER_ARCHS: List[str] = ["capsnet-mnist", "capsnet-fmnist"]


def list_archs(include_paper: bool = True) -> List[str]:
    return LM_ARCHS + (PAPER_ARCHS if include_paper else [])


def get_config(arch_id: str):
    try:
        return _MODULES[arch_id].CONFIG
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; known: "
                         f"{list_archs()}") from None


def reduced(cfg) -> Any:
    """Shrink a config to CPU-smoke size, preserving family and features."""
    if isinstance(cfg, CapsNetConfig):
        return dataclasses.replace(
            cfg, conv1_channels=16, caps_types=4, decoder_hidden=(32, 64))
    if not isinstance(cfg, LMConfig):
        raise TypeError(f"reduced: unsupported config {type(cfg).__name__}")
    kw: Dict[str, Any] = dict(
        n_layers=_reduced_layers(cfg),
        d_model=64,
        n_heads=max(2, min(cfg.n_heads, 4)),
        n_kv_heads=0,  # fixed below
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
        remat=False,
        remat_group=1,
        loss_chunks=2,
        max_seq_len=128,
        n_image_tokens=8 if cfg.cross_attn_every else cfg.n_image_tokens,
        attn_q_block=32,
        attn_kv_block=32,
    )
    kw["n_kv_heads"] = (kw["n_heads"] if cfg.n_kv_heads == cfg.n_heads
                        else max(1, kw["n_heads"] // 2))
    if cfg.d_head:
        kw["d_head"] = 16
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=8, top_k=min(cfg.moe.top_k, 2),
                              d_expert=32, n_shared=cfg.moe.n_shared,
                              capacity_factor=cfg.moe.capacity_factor)
        kw["d_ff"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk_size=16)
    if cfg.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(slstm_every=cfg.xlstm.slstm_every,
                                  mlstm_proj_factor=2.0,
                                  slstm_ff_factor=cfg.xlstm.slstm_ff_factor,
                                  d_conv=4, chunk_size=16)
    return dataclasses.replace(cfg, **kw)


def _reduced_layers(cfg: LMConfig) -> int:
    if cfg.family == "ssm":
        return cfg.xlstm.slstm_every          # one group
    if cfg.family == "vlm":
        return cfg.cross_attn_every + 1       # one group
    if cfg.family == "hybrid":
        return 2 * cfg.hybrid_attn_every      # two shared-attn sites
    return 2

"""Config registry of the port: the paper's two CapsNets and the ten LM
architectures of the reference, every family: dense (llama3.2-1b,
qwen3-1.7b, mistral-large-123b, qwen1.5-110b), moe (deepseek-moe-16b,
dbrx-132b), vlm (llama-3.2-vision-90b), ssm (xlstm-1.3b), hybrid
(zamba2-1.2b) and audio (hubert-xlarge, an encoder).

``get_config(arch_id)`` returns the full published config;
``reduced(cfg)`` returns a CPU-smoke-sized config of the same family, by
the reference's rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.configs import (capsnet_fmnist, capsnet_mnist, dbrx_132b,
                                 deepseek_moe_16b, hubert_xlarge, llama3p2_1b,
                                 llama3p2_vision_90b, mistral_large_123b,
                                 qwen1p5_110b, qwen3_1p7b, xlstm_1p3b,
                                 zamba2_1p2b)
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.models.common import LMConfig, MoEConfig, SSMConfig, XLSTMConfig

_MODULES = {
    "llama3.2-1b": llama3p2_1b,
    "qwen3-1.7b": qwen3_1p7b,
    "mistral-large-123b": mistral_large_123b,
    "qwen1.5-110b": qwen1p5_110b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "dbrx-132b": dbrx_132b,
    "llama-3.2-vision-90b": llama3p2_vision_90b,
    "xlstm-1.3b": xlstm_1p3b,
    "zamba2-1.2b": zamba2_1p2b,
    "hubert-xlarge": hubert_xlarge,
    "capsnet-mnist": capsnet_mnist,
    "capsnet-fmnist": capsnet_fmnist,
}

LM_ARCHS: List[str] = ["llama3.2-1b", "qwen3-1.7b", "mistral-large-123b",
                       "qwen1.5-110b", "deepseek-moe-16b", "dbrx-132b",
                       "llama-3.2-vision-90b", "xlstm-1.3b", "zamba2-1.2b",
                       "hubert-xlarge"]
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

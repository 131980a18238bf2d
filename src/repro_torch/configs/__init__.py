"""Config registry of the port: the paper's two CapsNets and the ten LM
architectures of the reference, every family: dense (llama3.2-1b,
qwen3-1.7b, mistral-large-123b, qwen1.5-110b), moe (deepseek-moe-16b,
dbrx-132b), vlm (llama-3.2-vision-90b), ssm (xlstm-1.3b), hybrid
(zamba2-1.2b) and audio (hubert-xlarge, an encoder).

``get_config(arch_id)`` returns the full published config;
``reduced(cfg)`` returns a CPU-smoke-sized config of the same family, by
the reference's rules; ``CELLS`` is the (arch x shape) dry-run matrix with
the reference's skip annotations; ``input_specs(cfg, shape)`` returns empty
tensors (on the meta device by default: nothing allocated) of the shapes
and types of every model input of a cell, where the reference returns
``ShapeDtypeStruct`` stand-ins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

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
# the reference's name and order for the ten LM archs (``CELLS`` follows it)
ASSIGNED_ARCHS: List[str] = [
    "zamba2-1.2b", "xlstm-1.3b", "mistral-large-123b", "llama3.2-1b",
    "qwen3-1.7b", "qwen1.5-110b", "deepseek-moe-16b", "dbrx-132b",
    "hubert-xlarge", "llama-3.2-vision-90b",
]


def list_archs(include_paper: bool = True) -> List[str]:
    return LM_ARCHS + (PAPER_ARCHS if include_paper else [])


def get_config(arch_id: str):
    try:
        return _MODULES[arch_id].CONFIG
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; known: "
                         f"{list_archs()}") from None


# ---------------------------------------------------------------------------
# Shapes / cells
# ---------------------------------------------------------------------------

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"seq": 4096,   "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768,  "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32768,  "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524288, "batch": 1,   "kind": "decode"},
}

# archs whose state is sub-quadratic in context (run long_500k)
_SUBQUADRATIC = {"zamba2-1.2b", "xlstm-1.3b"}
_ENCODER_ONLY = {"hubert-xlarge"}

ShapeInfo = Union[str, Mapping[str, Any]]


def shape_info(shape: ShapeInfo) -> Mapping[str, Any]:
    """A shape's ``{"seq", "batch", "kind"}``: ``SHAPES[shape]`` for a
    name, the mapping itself otherwise (a cell sized for one card)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_status(arch_id: str, shape: str) -> Optional[str]:
    """None if the cell runs; otherwise the skip reason (the reference's
    strings)."""
    if arch_id in _ENCODER_ONLY and SHAPES[shape]["kind"] == "decode":
        return "SKIP(encoder-only: no autoregressive decode step)"
    if shape == "long_500k" and arch_id not in _SUBQUADRATIC:
        return "SKIP(pure full attention: 500k context needs sub-quadratic)"
    return None


CELLS: List[Tuple[str, str]] = [
    (a, s) for a in ASSIGNED_ARCHS for s in SHAPES
]


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for (a, s) in CELLS if cell_status(a, s) is None]


# ---------------------------------------------------------------------------
# Input specs (empty tensors, on the meta device by default)
# ---------------------------------------------------------------------------


def input_specs(cfg: LMConfig, shape: ShapeInfo,
                device: Any = "meta") -> Dict[str, Any]:
    """Model-input stand-ins for a cell, empty tensors on ``device`` (the
    meta device allocates nothing).  For train and prefill these are the
    batch dict; decode gives tokens (B, 1) and ``pos``, a host ``int``: the
    last row of a cache of ``seq`` rows (the reference's is an int32
    scalar of no set value; a meta tensor cannot give the value that the
    decode step reads on the host, and a full cache is the step the
    shape names).  Caches are built separately (``lm.make_caches``)."""
    info = shape_info(shape)
    b, s = info["batch"], info["seq"]
    kind = info["kind"]
    i32, f32 = torch.int32, torch.float32

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if kind == "train":
        if cfg.family == "audio":
            return {"features": empty((b, s, cfg.d_model), f32),
                    "labels": empty((b, s), i32)}
        batch = {"tokens": empty((b, s), i32), "labels": empty((b, s), i32)}
        if cfg.family == "vlm":
            batch["image_features"] = empty(
                (b, cfg.n_image_tokens, cfg.d_model), f32)
        return batch
    if kind == "prefill":
        if cfg.family == "audio":
            return {"features": empty((b, s, cfg.d_model), f32)}
        batch = {"tokens": empty((b, s), i32)}
        if cfg.family == "vlm":
            batch["image_features"] = empty(
                (b, cfg.n_image_tokens, cfg.d_model), f32)
        return batch
    # decode: one new token against a KV/state cache of length s
    return {"tokens": empty((b, 1), i32), "pos": s - 1}


def batch_axes(cfg, shape: ShapeInfo) -> Dict[str, Any]:
    """Logical axes of the input batch (the reference's)."""
    kind = shape_info(shape)["kind"]
    ax: Dict[str, Any] = {}
    if kind in ("train", "prefill"):
        if getattr(cfg, "family", None) == "audio":
            ax["features"] = ("batch", "seq", "act_embed")
        else:
            ax["tokens"] = ("batch", "seq")
        if kind == "train":
            ax["labels"] = ("batch", "seq")
        if getattr(cfg, "family", None) == "vlm":
            ax["image_features"] = ("batch", None, "act_embed")
        return ax
    return {"tokens": ("batch", None), "pos": None}


# ---------------------------------------------------------------------------
# Reduced (smoke) configs: same family, CPU-sized
# ---------------------------------------------------------------------------


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

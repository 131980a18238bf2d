"""Full-fledged CapsNet (Sabour et al. [4], paper Fig. 3) in PyTorch.

Architecture (MNIST shapes):
    Conv1        9x9 conv, 1 -> 256 ch, stride 1, ReLU       -> (B, 20, 20, 256)
    PrimaryCaps  9x9 conv, 256 -> n_caps_types*caps_dim ch,
                 stride 2, reshape to capsules, squash       -> (B, 1152, 8)
    DigitCaps    per-(i, j) linear maps u_hat = W_ij u_i,
                 dynamic routing (core/routing.py)           -> (B, 10, 16)
    Decoder      FC 160 -> 512 -> 1024 -> 784, sigmoid (reconstruction reg.)

Loss: margin loss (Sabour Eq. 4) + 0.0005 * MSE reconstruction.  It is
differentiable through the ``reference`` routing only: the ``cuda`` and
``optimized`` variants run the hand-written kernels, whose wrappers refuse a
tensor that needs a gradient (the reference package trains through
``RoutingSpec.reference()`` too).

Layouts at the public functions are the reference's: images NHWC, conv
weights OIHW, ``digit.w`` (N_in, N_out, d_in, d_out), capsule index =
(type, y, x).  So parameters convert leaf by leaf, LAKP scores the same
kernels and ``compact``'s index vectors mean the same thing.  The two
convolutions are library calls (``F.conv2d``, which wants NCHW: the
permutation happens inside) and so is the prediction einsum; the routing
goes through the variant the config names.

Pruning integration (paper Fig. 6): conv weights are stored OIHW so
``core/lakp`` can score/mask kernels directly.  ``compact()`` physically
removes capsule *types* whose conv2 channels were fully pruned — 1152 -> 252
capsules on MNIST in the paper — shrinking the routing weight W from
(1152, 10, 8, 16) to (252, 10, 8, 16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import approx_math
from repro_torch.deploy.registry import RoutingSpec, resolve as resolve_routing
from repro_torch.models.common import (ParamDef, fanin_init, init_params,
                                       param_specs, zeros_init)


@dataclasses.dataclass(frozen=True)
class CapsNetConfig:
    arch_id: str = "capsnet-mnist"
    image_hw: int = 28
    in_channels: int = 1
    n_classes: int = 10
    conv1_channels: int = 256
    conv1_kernel: int = 9
    caps_types: int = 32          # PrimaryCaps capsule types
    caps_dim: int = 8             # PrimaryCaps capsule dimension
    caps_kernel: int = 9
    caps_stride: int = 2
    digit_dim: int = 16           # DigitCaps dimension
    routing_iters: int = 3
    # Typed routing spec (repro_torch.deploy); None means the reference variant.
    routing: Optional[RoutingSpec] = None
    decoder_hidden: Tuple[int, int] = (512, 1024)
    recon_weight: float = 0.0005
    param_dtype: str = "float32"
    # margin loss constants (Sabour Eq. 4)
    m_plus: float = 0.9
    m_minus: float = 0.1
    lambda_down: float = 0.5

    @property
    def conv1_out_hw(self) -> int:
        return self.image_hw - self.conv1_kernel + 1

    @property
    def caps_out_hw(self) -> int:
        return (self.conv1_out_hw - self.caps_kernel) // self.caps_stride + 1

    @property
    def n_primary_caps(self) -> int:
        return self.caps_types * self.caps_out_hw ** 2

    @property
    def primary_conv_channels(self) -> int:
        return self.caps_types * self.caps_dim

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def routing_spec(self) -> RoutingSpec:
        """The effective RoutingSpec (reference routing when unset)."""
        if self.routing is not None:
            return self.routing
        return RoutingSpec.reference()


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def capsnet_defs(cfg: CapsNetConfig) -> Dict[str, Any]:
    k1, k2 = cfg.conv1_kernel, cfg.caps_kernel
    c1 = cfg.conv1_channels
    c2 = cfg.primary_conv_channels
    n_in, n_out = cfg.n_primary_caps, cfg.n_classes
    d_in, d_out = cfg.caps_dim, cfg.digit_dim
    img = cfg.image_hw ** 2 * cfg.in_channels
    h1, h2 = cfg.decoder_hidden
    return {
        # OIHW conv weights (LAKP scores kernels on this layout directly)
        "conv1": {
            "w": ParamDef((c1, cfg.in_channels, k1, k1),
                          ("conv_out", "conv_in", None, None),
                          fanin_init(cfg.in_channels * k1 * k1)),
            "b": ParamDef((c1,), ("conv_out",), zeros_init()),
        },
        "conv2": {
            "w": ParamDef((c2, c1, k2, k2), ("conv_out", "conv_in", None, None),
                          fanin_init(c1 * k2 * k2)),
            "b": ParamDef((c2,), ("conv_out",), zeros_init()),
        },
        # DigitCaps transform: u_hat[b,i,j,:] = u[b,i,:] @ W[i,j]
        "digit": {
            "w": ParamDef((n_in, n_out, d_in, d_out),
                          ("caps_in", "caps_out", None, None),
                          fanin_init(d_in)),
        },
        "decoder": {
            "w1": ParamDef((n_out * d_out, h1), (None, "mlp"), fanin_init()),
            "b1": ParamDef((h1,), ("mlp",), zeros_init()),
            "w2": ParamDef((h1, h2), ("mlp", None), fanin_init()),
            "b2": ParamDef((h2,), (None,), zeros_init()),
            "w3": ParamDef((h2, img), (None, None), fanin_init()),
            "b3": ParamDef((img,), (None,), zeros_init()),
        },
    }


def init(cfg: CapsNetConfig, generator: torch.Generator,
         device: Any = "cpu") -> Dict[str, Any]:
    return init_params(capsnet_defs(cfg), generator, cfg.pdtype(), device)


def specs(cfg: CapsNetConfig) -> Dict[str, Any]:
    """Shapes, types and logical axes of the params, nothing allocated (a
    target for ``repro_torch.checkpointing.load``)."""
    return param_specs(capsnet_defs(cfg), cfg.pdtype())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def primary_capsules(params: Dict[str, Any], cfg: CapsNetConfig,
                     images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> squashed primary capsules (B, N_in, caps_dim)."""
    x = images.permute(0, 3, 1, 2)                    # NHWC -> NCHW
    # OIHW weights, VALID padding
    h = torch.relu(F.conv2d(x, params["conv1"]["w"], params["conv1"]["b"]))
    h = F.conv2d(h, params["conv2"]["w"], params["conv2"]["b"],
                 stride=cfg.caps_stride)              # (B, types*dim, 6, 6)
    b = h.shape[0]
    hw = cfg.caps_out_hw
    # channel layout: (types, dim); capsule index = (type, y, x), as the
    # reference orders them
    h = h.reshape(b, h.shape[1] // cfg.caps_dim, cfg.caps_dim, hw, hw)
    h = h.permute(0, 1, 3, 4, 2).reshape(b, -1, cfg.caps_dim)
    return approx_math.squash(h, axis=-1)


def predictions(params: Dict[str, Any], u: torch.Tensor) -> torch.Tensor:
    """u (B, N_in, d_in) x W (N_in, N_out, d_in, d_out) -> u_hat."""
    return torch.einsum("bid,ijde->bije", u, params["digit"]["w"])


def digit_capsules(params: Dict[str, Any], cfg: CapsNetConfig,
                   u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    u_hat = predictions(params, u).contiguous()
    route_fn = resolve_routing(cfg.routing_spec())
    return route_fn(u_hat, n_iters=cfg.routing_iters)


def decode(params: Dict[str, Any], cfg: CapsNetConfig, v: torch.Tensor,
           labels: torch.Tensor) -> torch.Tensor:
    """Reconstruction decoder; masks all but the true class's capsule."""
    d = params["decoder"]
    mask = F.one_hot(labels.long(), cfg.n_classes).to(v.dtype)  # (B, J)
    x = (v * mask[:, :, None]).reshape(v.shape[0], -1)
    x = torch.relu(x @ d["w1"] + d["b1"])
    x = torch.relu(x @ d["w2"] + d["b2"])
    return torch.sigmoid(x @ d["w3"] + d["b3"])


def forward(params: Dict[str, Any], cfg: CapsNetConfig, images: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images -> (class capsule lengths (B, n_classes), capsules v)."""
    u = primary_capsules(params, cfg, images)
    v, _ = digit_capsules(params, cfg, u)
    lengths = torch.linalg.vector_norm(v.to(torch.float32), dim=-1)
    return lengths, v


# ---------------------------------------------------------------------------
# Losses / metrics
# ---------------------------------------------------------------------------


def margin_loss(lengths: torch.Tensor, labels: torch.Tensor,
                cfg: CapsNetConfig) -> torch.Tensor:
    t = F.one_hot(labels.long(), cfg.n_classes).to(torch.float32)
    pos = torch.square(torch.clamp(cfg.m_plus - lengths, min=0.0))
    neg = torch.square(torch.clamp(lengths - cfg.m_minus, min=0.0))
    per_class = t * pos + cfg.lambda_down * (1.0 - t) * neg
    return torch.mean(torch.sum(per_class, dim=-1))


def loss_fn(params: Dict[str, Any], cfg: CapsNetConfig,
            images: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    u = primary_capsules(params, cfg, images)
    v, _ = digit_capsules(params, cfg, u)
    # the offset keeps the norm's gradient finite at v = 0
    lengths = torch.linalg.vector_norm(v.to(torch.float32) + 1e-12, dim=-1)
    l_margin = margin_loss(lengths, labels, cfg)
    recon = decode(params, cfg, v, labels)
    flat = images.reshape(images.shape[0], -1).to(torch.float32)
    l_recon = torch.mean(torch.sum(torch.square(recon - flat), dim=-1))
    loss = l_margin + cfg.recon_weight * l_recon
    acc = torch.mean((torch.argmax(lengths, -1) == labels).to(torch.float32))
    return loss, {"loss": loss, "margin": l_margin,
                  "recon": l_recon, "acc": acc}


# ---------------------------------------------------------------------------
# Pruning integration (paper Fig. 6 pipeline)
# ---------------------------------------------------------------------------


def conv_chain(params: Dict[str, Any]) -> list:
    """The prunable conv chain, with DigitCaps W as conv2's look-ahead
    neighbour (folded to a dense matrix by :func:`digit_w_as_dense`)."""
    return [params["conv1"]["w"], params["conv2"]["w"], params["digit"]["w"]]


def digit_w_as_dense(w_digit: torch.Tensor, caps_types: int, caps_dim: int,
                     hw: int) -> torch.Tensor:
    """(N_in, N_out, d_in, d_out) -> (types*caps_dim [conv2 out ch], rest).

    Capsule i = (type t, spatial p); its d_in inputs are conv2 channels
    t*caps_dim..+caps_dim.  Summing |W| over spatial positions gives the
    dense next-layer weight LAKP expects: rows = conv2 out channels.
    """
    n_in, n_out, d_in, d_out = w_digit.shape
    w = w_digit.abs().reshape(caps_types, hw * hw, n_out, d_in, d_out)
    w = w.sum(dim=1)                              # (types, n_out, d_in, d_out)
    return w.permute(0, 2, 1, 3).reshape(caps_types * d_in, n_out * d_out)


def lakp_masks(params: Dict[str, Any], cfg: CapsNetConfig,
               sparsity_conv1: float, sparsity_conv2: float,
               method: str = "lakp", norm: str = "l1",
               type_keep: Optional[int] = None):
    """Score + mask the two conv layers (the paper prunes Conv1 and the
    PrimaryCaps conv).  Returns (mask1, mask2).

    ``type_keep``: the paper's "interconnection study" step (Fig. 6) —
    after kernel masking, whole capsule *types* are eliminated down to the
    ``type_keep`` highest-scored ones (paper: 32 -> 7 on MNIST, 32 -> 12 on
    F-MNIST), zeroing every kernel of the dropped types."""
    from repro_torch.core import lakp as lakp_lib

    w1, w2 = params["conv1"]["w"], params["conv2"]["w"]
    w_next = digit_w_as_dense(params["digit"]["w"], cfg.caps_types,
                              cfg.caps_dim, cfg.caps_out_hw)
    if method == "lakp":
        # w_next is (conv2_out_ch, n_out*d_out) == dense (in, out) layout
        s1 = lakp_lib.lakp_kernel_scores(w1, None, w2, norm=norm)
        s2 = lakp_lib.lakp_kernel_scores(w2, w1, w_next, norm=norm)
    elif method == "kp":
        s1, s2 = lakp_lib.kp_scores(w1), lakp_lib.kp_scores(w2)
    else:
        raise ValueError(method)
    m1 = lakp_lib.mask_from_scores(s1, sparsity_conv1)
    m2 = lakp_lib.mask_from_scores(s2, sparsity_conv2)
    if type_keep is not None and type_keep < cfg.caps_types:
        m2 = eliminate_capsule_types(s2 * m2, cfg, type_keep)
    return m1, m2


def eliminate_capsule_types(masked_scores2: torch.Tensor, cfg: CapsNetConfig,
                            keep: int) -> torch.Tensor:
    """Keep only the ``keep`` capsule types with the highest surviving
    kernel score; zero all kernels of the other types (and keep the
    surviving-kernel mask within kept types).  Ties rank by type index
    (stable sort), as in the reference."""
    o, i = masked_scores2.shape
    per_type = masked_scores2.reshape(cfg.caps_types, cfg.caps_dim, i)
    type_scores = per_type.sum(dim=(1, 2))                  # (types,)
    order = torch.argsort(-type_scores, stable=True)
    keep_idx = order[:keep]
    type_mask = torch.zeros((cfg.caps_types,), dtype=torch.float32,
                            device=masked_scores2.device)
    type_mask[keep_idx] = 1.0
    ch_mask = torch.repeat_interleave(type_mask, cfg.caps_dim)  # (O,)
    return (masked_scores2 > 0).to(torch.float32) * ch_mask[:, None]


def apply_masks(params: Dict[str, Any], masks) -> Dict[str, Any]:
    from repro_torch.core import lakp as lakp_lib

    m1, m2 = masks
    out = dict(params)                       # shallow copy
    out["conv1"] = dict(params["conv1"])
    out["conv2"] = dict(params["conv2"])
    out["conv1"]["w"] = lakp_lib.apply_kernel_mask(params["conv1"]["w"], m1)
    out["conv2"]["w"] = lakp_lib.apply_kernel_mask(params["conv2"]["w"], m2)
    return out


def compact(params: Dict[str, Any], cfg: CapsNetConfig, masks
            ) -> Tuple[Dict[str, Any], CapsNetConfig, Dict[str, torch.Tensor]]:
    """Physically remove pruned structures (paper §III-C index memory).

    * conv1: output channels with no surviving kernel are removed (and the
      corresponding conv2 input channels).
    * conv2: capsule *types* whose all caps_dim channels lost every kernel
      are removed — this is the 1152 -> 252 capsule elimination — and the
      DigitCaps weight rows for those capsules are removed.

    Returns (compacted params, updated config, surviving index vectors);
    the index vectors are ascending, as ``nonzero`` gives them.
    """
    m1, m2 = masks
    w1, b1 = params["conv1"]["w"], params["conv1"]["b"]
    w2, b2 = params["conv2"]["w"], params["conv2"]["b"]
    wd = params["digit"]["w"]

    alive1 = torch.nonzero((m1 > 0).any(dim=1))[:, 0]         # conv1 out ch
    w1c = w1[alive1]
    b1c = b1[alive1]
    w2c = w2[:, alive1]                                       # conv2 in ch

    # capsule types: group conv2 out channels by caps_dim
    alive_ch = (m2 > 0).any(dim=1)                            # (O2,)
    types_alive = alive_ch.reshape(cfg.caps_types, cfg.caps_dim).any(dim=1)
    type_idx = torch.nonzero(types_alive)[:, 0]               # surviving types
    ch_idx = (type_idx[:, None] * cfg.caps_dim
              + torch.arange(cfg.caps_dim, device=type_idx.device)[None, :]
              ).reshape(-1)
    w2c = w2c[ch_idx]
    b2c = b2[ch_idx]

    # DigitCaps rows: capsule i = (type, spatial); keep surviving types
    hw2 = cfg.caps_out_hw ** 2
    wd_t = wd.reshape(cfg.caps_types, hw2, cfg.n_classes, cfg.caps_dim,
                      cfg.digit_dim)
    wd_c = wd_t[type_idx].reshape(-1, cfg.n_classes, cfg.caps_dim,
                                  cfg.digit_dim)

    new_cfg = dataclasses.replace(
        cfg,
        conv1_channels=int(alive1.shape[0]),
        caps_types=int(type_idx.shape[0]),
    )
    out = {
        "conv1": {"w": w1c.contiguous(), "b": b1c.contiguous()},
        "conv2": {"w": w2c.contiguous(), "b": b2c.contiguous()},
        "digit": {"w": wd_c.contiguous()},
        "decoder": params["decoder"],
    }
    index = {"conv1_out": alive1, "caps_types": type_idx}
    return out, new_cfg, index


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: Dict[str, Any]) -> int:
    return sum(int(x.numel()) for x in _leaves(params))

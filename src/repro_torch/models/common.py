"""Shared model substrate: configs, parameter declaration, norms, RoPE,
activations, embeddings.

Parameters are plain nested dicts of tensors, declared as a tree of
:class:`ParamDef` and initialised from one explicit ``torch.Generator``.
The port's init does not reproduce ``jax.random``'s bits (the parity tests
convert the reference's parameters instead); it keeps the distribution:
truncated normal at +-2 sigma with the declared std, zero biases, unit norm
scales.  Values are drawn on the generator's device, so a CUDA generator
initialises a full-size model on the card without a host round trip.

:class:`LMConfig` carries every field of the reference's config, so the
config files copy verbatim.  Training reads ``remat``, ``remat_group``
and ``loss_remat`` (``repro_torch.models.lm``); ``scan_layers`` and
``attn_scan_remat`` shape the reference's compiled scans and are kept but
ignored (the port loops eagerly), and so is ``loss_chunks``, which the
reference's ``loss_fn`` does not read either.  ``attn_impl`` is ``chunked | reference | cuda`` and
``decode_impl`` is ``chunked | cuda`` (the reference's ``pallas`` is the
port's ``cuda``: the hand-written kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

InitFn = Callable[[torch.Generator, Tuple[int, ...], torch.dtype], torch.Tensor]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Fine-grained mixture of experts (``repro_torch.models.moe``):
    ``n_experts`` routed experts of width ``d_expert``, ``top_k`` of them a
    token, ``n_shared`` always-on experts fused into one dense FFN.
    ``dispatch`` is ``onehot`` (GShard einsums) or ``scatter`` (per-row
    sort and scatter); ``global_decode_dispatch`` routes a one-token decode
    step's batch as one row, so the capacity floor applies once."""

    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch: str = "onehot"
    global_decode_dispatch: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block of the hybrid family
    (``repro_torch.models.mamba2``): ``expand * d_model`` inner channels in
    heads of ``head_dim``, ``n_groups`` groups of B / C of ``d_state``, a
    causal convolution of ``d_conv`` taps, scanned in chunks of
    ``chunk_size``."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM blocks of the ssm family (``repro_torch.models.xlstm``): every
    ``slstm_every``-th block an sLSTM (a ``slstm_ff_factor`` gated FFN
    after it), the others mLSTM blocks with a ``mlstm_proj_factor`` up
    projection, a ``d_conv``-tap causal convolution and a chunked scan of
    ``chunk_size``."""

    slstm_every: int = 8
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 1.3333
    d_conv: int = 4
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 -> d_model // n_heads
    act: str = "silu"             # silu -> SwiGLU; gelu -> plain GELU MLP
    glu: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    causal: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0
    xlstm: Optional[XLSTMConfig] = None
    cross_attn_every: int = 0
    n_image_tokens: int = 1024
    frontend: Optional[str] = None   # None | audio | vision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True            # checkpoint each unit group (training)
    remat_group: int = 1          # units per checkpointed group
    loss_chunks: int = 0          # kept, ignored (as by the reference's loss)
    scan_layers: bool = True      # kept, ignored (the port loops)
    attn_q_block: int = 512
    attn_kv_block: int = 1024     # chunked attention's KV block
    attn_impl: str = "chunked"    # chunked | reference | cuda
    decode_impl: str = "chunked"  # chunked | cuda (the decode kernel)
    attn_scan_remat: bool = True  # kept, ignored (the port loops)
    loss_remat: bool = True       # checkpoint each CE chunk (training)
    softmax_mode: str = "exact"   # exact | taylor (FastCaps Eq. 2)
    max_seq_len: int = 8192

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_self_layers(self) -> int:
        if self.cross_attn_every:
            k = self.cross_attn_every
            return self.n_layers * k // (k + 1)
        return self.n_layers

    def n_cross_layers(self) -> int:
        if self.cross_attn_every:
            return self.n_layers - self.n_self_layers()
        return 0

    def param_count(self, params=None) -> int:
        if params is None:
            raise ValueError("pass a params tree")
        return sum(int(x.numel()) for x in tree_leaves(params))


def tree_leaves(tree: Any) -> list:
    """Tensors of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts and lists (and of trees of
    the same structure, ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) in the structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# Param declaration
# ---------------------------------------------------------------------------


def _trunc_normal(gen: torch.Generator, shape, std: float, dtype):
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (x * std).to(dtype)


def normal_init(stddev: float) -> InitFn:
    def init(gen, shape, dtype):
        return _trunc_normal(gen, shape, stddev, dtype)

    return init


def zeros_init() -> InitFn:
    def init(gen, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=gen.device)

    return init


def ones_init() -> InitFn:
    def init(gen, shape, dtype):
        return torch.ones(shape, dtype=dtype, device=gen.device)

    return init


def fanin_init(fan_in: Optional[int] = None) -> InitFn:
    def init(gen, shape, dtype):
        fi = fan_in if fan_in is not None else shape[0]
        return _trunc_normal(gen, shape, 1.0 / math.sqrt(max(fi, 1)), dtype)

    return init


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: InitFn

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A parameter that is not allocated: its shape, type and logical axes.
    ``checkpoint.load`` takes a tree of these as its target."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...]


def param_specs(defs: Any, dtype: torch.dtype) -> Any:
    """A tree of ParamDefs -> the tree of their :class:`LeafSpec`."""
    if isinstance(defs, ParamDef):
        return LeafSpec(tuple(defs.shape), dtype, tuple(defs.axes))
    if isinstance(defs, list):
        return [param_specs(v, dtype) for v in defs]
    return {k: param_specs(v, dtype) for k, v in defs.items()}


def stack_specs(specs: Any, n: int) -> Any:
    """Prepend the stacked ``layers`` axis, of ``n`` units, to every
    :class:`LeafSpec` of a unit's spec tree (the reference's
    ``stack_specs``, which prepends the axis name alone)."""
    if isinstance(specs, LeafSpec):
        return LeafSpec((n,) + specs.shape, specs.dtype,
                        ("layers",) + specs.axes)
    if isinstance(specs, list):
        return [stack_specs(v, n) for v in specs]
    return {k: stack_specs(v, n) for k, v in specs.items()}


def param_numel(defs: Any) -> int:
    """Elements of a tree of ParamDefs, without allocating them."""
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    vals = defs if isinstance(defs, list) else defs.values()
    return sum(param_numel(v) for v in vals)


def init_params(defs: Any, generator: torch.Generator, dtype: torch.dtype,
                device: Any = "cpu") -> Any:
    """Initialise a tree (dicts and lists) of ParamDefs into tensors.

    Values are drawn on the generator's device from ``generator`` in the
    tree's key order (so one seed and one generator device give one model)
    and then moved to ``device``."""
    if isinstance(defs, ParamDef):
        return defs.init(generator, defs.shape, dtype).to(device)
    if isinstance(defs, list):
        return [init_params(v, generator, dtype, device) for v in defs]
    return {k: init_params(v, generator, dtype, device)
            for k, v in defs.items()}


def init_stacked(defs: Any, n: int, generator: torch.Generator,
                 dtype: torch.dtype, device: Any = "cpu") -> Any:
    """``n`` independent draws of a ParamDef tree, stacked on a new leading
    axis (the reference's ``vmap`` over per-unit keys).  Each unit slice is
    drawn with the declared per-unit shape, so fan-in rules see the shape
    they were written for."""
    if isinstance(defs, ParamDef):
        out = torch.empty((n,) + tuple(defs.shape), dtype=dtype,
                          device=device)
        for i in range(n):
            out[i] = defs.init(generator, defs.shape, dtype).to(device)
        return out
    if isinstance(defs, list):
        return [init_stacked(v, n, generator, dtype, device) for v in defs]
    return {k: init_stacked(v, n, generator, dtype, device)
            for k, v in defs.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(dim: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((dim,), (None,), ones_init())}


def layernorm_defs(dim: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((dim,), (None,), ones_init()),
            "bias": ParamDef((dim,), (None,), zeros_init())}


def norm_defs(cfg: LMConfig, dim: Optional[int] = None) -> Dict[str, ParamDef]:
    d = dim if dim is not None else cfg.d_model
    return layernorm_defs(d) if cfg.norm == "layernorm" else rmsnorm_defs(d)


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: LMConfig, eps: Optional[float] = None) -> torch.Tensor:
    """RMS or layer norm in float32; returns ``x``'s type."""
    eps = cfg.norm_eps if eps is None else eps
    xf = x.float()
    if "bias" in params:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_norm_simple(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free RMS norm (the qk-norm building block)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: Any = "cpu") -> torch.Tensor:
    """1 / theta^(i / half) in float32, made where it is used (a Python
    base: no host-to-device copy, which would stall the host)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(theta), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE in float32, cast back.  x: (..., seq, heads,
    head_dim); positions: (..., seq) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_defs(cfg: LMConfig) -> Dict[str, ParamDef]:
    defs: Dict[str, Any] = {}
    if cfg.frontend is None:
        defs["tok"] = ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                               normal_init(1.0))
    else:
        defs["frontend_proj"] = ParamDef(
            (cfg.d_model, cfg.d_model), ("embed", "embed_tp"), fanin_init())
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef(
            (cfg.d_model, cfg.vocab), ("embed", "vocab"),
            normal_init(cfg.d_model ** -0.5))
    return defs


def embed_inputs(params, cfg: LMConfig, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """Token lookup in the (float32) table, scaled by sqrt(d_model) in the
    table's type, then cast to the compute type."""
    if cfg.frontend is None:
        x = params["tok"][batch["tokens"].long()]
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    else:
        cd = cfg.cdtype()
        x = batch["features"].to(cd) @ params["frontend_proj"].to(cd)
    return x.to(cfg.cdtype())


def fixed_order_route(cfg: LMConfig, *xs: torch.Tensor) -> bool:
    """Whether a serving projection takes the port's fixed-order GEMM
    (:func:`fixed_matmul`): on the kernel path (``cfg.attn_impl ==
    "cuda"``) when no gradient is asked of the product; the kernel has no
    backward, so training keeps torch's product."""
    if cfg.attn_impl != "cuda":
        return False
    return not (torch.is_grad_enabled() and any(x.requires_grad for x in xs))


def fixed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) as one 2-D product over the flattened rows
    through ``kernels.fixed_order_matmul``: one tile and one K order for
    every row count, so a request's rows take the same bits whoever shares
    the call (on a CPU tensor its plain version).  ``w`` is read as stored
    (row-major, or the transpose of a row-major table)."""
    from repro_torch import kernels

    y = kernels.fixed_order_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                                   w)
    return y.view(*x.shape[:-1], w.shape[-1])


def unembed(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits in the compute type, cast to float32 (then soft-capped).  A
    tied model reads ``tok_cd`` (the compute-type copy of the table an
    engine makes once) when it is there, else casts ``tok``.  On
    :func:`fixed_order_route` the product is :func:`fixed_matmul`'s."""
    cd = cfg.cdtype()
    if cfg.tie_embeddings:
        w = params.get("tok_cd", params["tok"]).to(cd).T
    else:
        w = params["unembed"].to(cd)
    x = x.to(cd)
    y = fixed_matmul(x, w) if fixed_order_route(cfg, x, w) else x @ w
    return softcap(y.float(), cfg.logit_softcap)

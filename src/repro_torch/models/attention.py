"""Attention: GQA/MHA with RoPE, qk-norm, qkv-bias and a dense KV cache.

Three interchangeable inner implementations (``cfg.attn_impl``):

  * ``reference`` — the full score matrix, for tests and small shapes;
  * ``chunked``   — flash-style online softmax over KV blocks (a Python loop
                    over blocks of ``cfg.attn_kv_block``);
  * ``cuda``      — the registry's ``flash_attention`` kernel for prefill
                    (hand-written for Hopper; its plain version for CPU
                    tensors).  Decode and masked-cache reads stay chunked.

The q_len = 1 decode read goes through the ``decode_attention`` kernel when
``cfg.decode_impl == "cuda"`` and through the chunked path otherwise.

``softmax_mode="taylor"`` swaps the exact exp for the FastCaps Eq. 2
polynomial with range reduction (``repro_torch.core.approx_math``).

Caches are updated **in place** (``index_put_`` / slice assignment) where
the reference returns a new tree: ``self_attention`` writes the fresh K/V
rows into the cache tensors it is given and returns the same dict.  The
int8 (``k_scale`` leaves) and paged (``paged_tables``) caches come with the
paged slice of the port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import approx_math
from repro_torch.models import common
from repro_torch.models.common import (LMConfig, ParamDef, fanin_init,
                                       ones_init, zeros_init)

NEG_INF = -1e30

# int8 cache rows: symmetric per-row scales, one float32 scale per
# (position) row of K and of V (the paged slice stores them).
KV_QUANT_MAX = 127.0
KV_QUANT_EPS = 1e-8

_PAGED_SLICE = ("int8 and paged KV caches are served by the paged slice of "
                "the port, not yet by this one")


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) rows -> (int8 rows, float32 per-row scales (...,))."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp(amax / KV_QUANT_MAX, min=KV_QUANT_EPS)
    q = torch.clamp(torch.round(xf / scale[..., None, None]),
                    -KV_QUANT_MAX, KV_QUANT_MAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Invert :func:`quantize_kv_rows`; broadcasts (...,) scales."""
    return (q.float() * scale[..., None, None]).to(dtype)


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def attention_defs(cfg: LMConfig, cross: bool = False) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    defs: Dict[str, Any] = {
        "wq": ParamDef((d, nh, hd), ("embed", "heads", "head_dim"),
                       fanin_init(d)),
        "wk": ParamDef((d, nkv, hd), ("embed", "kv_heads", "head_dim"),
                       fanin_init(d)),
        "wv": ParamDef((d, nkv, hd), ("embed", "kv_heads", "head_dim"),
                       fanin_init(d)),
        "wo": ParamDef((nh, hd, d), ("heads", "head_dim", "embed"),
                       fanin_init(nh * hd)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((nh, hd), ("heads", "head_dim"), zeros_init())
        defs["bk"] = ParamDef((nkv, hd), ("kv_heads", "head_dim"),
                              zeros_init())
        defs["bv"] = ParamDef((nkv, hd), ("kv_heads", "head_dim"),
                              zeros_init())
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), ones_init())
        defs["k_norm"] = ParamDef((hd,), (None,), ones_init())
    if cross:
        defs["gate"] = ParamDef((), (), zeros_init())
    return defs


# ---------------------------------------------------------------------------
# Softmax variants
# ---------------------------------------------------------------------------


def _exp(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "taylor":
        return approx_math.taylor_exp(x, range_reduce=True)
    return torch.exp(x)


def _masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                    mode: str) -> torch.Tensor:
    """Softmax over the last axis in float32; mask True = attend."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=NEG_INF)
    e = _exp(scores - m, mode)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _project_qkv(params, cfg: LMConfig, xq: torch.Tensor, xkv: torch.Tensor):
    cd = cfg.cdtype()
    q = torch.einsum("bsd,dhk->bshk", xq.to(cd), params["wq"].to(cd))
    k = torch.einsum("btd,dhk->bthk", xkv.to(cd), params["wk"].to(cd))
    v = torch.einsum("btd,dhk->bthk", xkv.to(cd), params["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    if cfg.qk_norm:
        q = common.rms_norm_simple(q) * params["q_norm"].to(cd)
        k = common.rms_norm_simple(k) * params["k_norm"].to(cd)
    return q, k, v


def _out_proj(params, cfg: LMConfig, attn_out: torch.Tensor) -> torch.Tensor:
    cd = cfg.cdtype()
    return torch.einsum("bshk,hkd->bsd", attn_out.to(cd), params["wo"].to(cd))


def _group_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, K, G, D) where H = K * G."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


# ---------------------------------------------------------------------------
# Inner attention implementations
# ---------------------------------------------------------------------------


def _reference_attention(q, k, v, cfg: LMConfig, causal: bool,
                         q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, K, D) -> (B, S, H, D)."""
    b, s, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qg = _group_heads(q, nkv)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * (1.0 / math.sqrt(d))
    mask = None
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None, None]
    p = _masked_softmax(scores, mask, cfg.softmax_mode).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(b, s, h, d)


def _chunked_attention(q, k, v, cfg: LMConfig, causal: bool,
                       q_offset: int = 0,
                       kv_valid_len: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Flash-style online softmax over KV blocks.

    q: (B, S, H, D); k, v: (B, T, K, D); the KV block is the largest power
    of two fraction of ``cfg.attn_kv_block`` that divides T.  ``p`` is
    rounded to v's type before the PV product, as in the reference.
    ``kv_valid_len``: optional (B,), masks cache positions >= len.
    """
    b, s, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    blk = min(cfg.attn_kv_block, t)
    while t % blk:
        blk //= 2
    g = h // nkv
    qg = _group_heads(q, nkv)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qpos = (torch.arange(s, device=dev) + q_offset)[None, :]        # (1, S)
    m = torch.full((b, nkv, g, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nkv, g, s, d), dtype=torch.float32, device=dev)
    for start in range(0, t, blk):
        kblk, vblk = k[:, start:start + blk], v[:, start:start + blk]
        kpos = start + torch.arange(blk, device=dev)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kblk).float() * scale
        mask = torch.ones((b, 1, 1, s, blk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, :, None])[:, None, None]
        if kv_valid_len is not None:
            mask = mask & (kpos[None, :] < kv_valid_len[:, None]
                           )[:, None, None, None]
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = _exp(m - m_new, cfg.softmax_mode)
        p = torch.where(mask, _exp(scores - m_new[..., None],
                                   cfg.softmax_mode), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vblk.dtype), vblk)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _inner_attention(q, k, v, cfg: LMConfig, causal: bool, q_offset: int = 0,
                     kv_valid_len=None) -> torch.Tensor:
    if cfg.attn_impl == "reference":
        if kv_valid_len is not None:
            raise ValueError("reference attention takes no kv_valid_len")
        return _reference_attention(q, k, v, cfg, causal, q_offset)
    if cfg.attn_impl == "cuda":
        if kv_valid_len is None and q.shape[1] > 1:
            from repro_torch import kernels

            return kernels.flash_attention(q, k, v, causal=causal,
                                           q_offset=q_offset,
                                           softmax_mode=cfg.softmax_mode)
        # decode and masked-cache reads take the chunked path
    elif cfg.attn_impl != "chunked":
        raise ValueError(f"attn_impl must be chunked, reference or cuda, got "
                         f"{cfg.attn_impl!r}")
    return _chunked_attention(q, k, v, cfg, causal, q_offset, kv_valid_len)


# ---------------------------------------------------------------------------
# Public layer entry point
# ---------------------------------------------------------------------------


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor) -> None:
    """cache[rows, idx] = new, in place; an index past the cache drops its
    write (the reference's scatter drops out-of-range updates), without a
    host synchronisation."""
    t = cache.shape[1]
    ok = (idx >= 0) & (idx < t)
    idx_c = idx.clamp(0, t - 1)
    keep = cache[rows, idx_c]
    cache[rows, idx_c] = torch.where(ok[:, None, None], new.to(cache.dtype),
                                     keep)


def self_attention(params, cfg: LMConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: Any = None,
                   prefill_offset: int = 0,
                   paged_tables=None,
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention with an optional dense KV cache (updated in place).

    Modes:
      * cache None                   — training / encoder forward;
      * cache given, x.shape[1] > 1  — prefill: writes cache[off:off+S]
                                       (``off = prefill_offset``; off > 0 is a
                                       continuation prefill attending the
                                       cached prefix);
      * cache given, x.shape[1] == 1 — decode: writes cache[idx] and attends
                                       to cache[0:idx+1].  A vector
                                       ``cache_index`` (B,) gives every slot
                                       its own row; a scalar one is shared.
    """
    if paged_tables is not None or (cache is not None and "k_scale" in cache):
        raise NotImplementedError(_PAGED_SLICE)
    q, k, v = _project_qkv(params, cfg, x, x)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _inner_attention(q, k, v, cfg, causal=cfg.causal)
        return _out_proj(params, cfg, out), None

    ck, cv = cache["k"], cache["v"]
    s = x.shape[1]
    off = int(prefill_offset)
    if s > 1:
        if off and not cfg.causal:
            raise ValueError("continuation prefill requires a causal model")
        if off + s > ck.shape[1]:
            raise ValueError(f"prefill rows [{off}, {off + s}) pass the "
                             f"cache length {ck.shape[1]}")
        ck[:, off:off + s] = k.to(ck.dtype)
        cv[:, off:off + s] = v.to(cv.dtype)
        if off:
            t = off + s
            out = _inner_attention(q, ck[:, :t].to(q.dtype),
                                   cv[:, :t].to(q.dtype), cfg, causal=True,
                                   q_offset=off)
        else:
            out = _inner_attention(q, k, v, cfg, causal=cfg.causal)
        return _out_proj(params, cfg, out), cache

    b = x.shape[0]
    idx = cache_index if cache_index is not None else positions[:, 0].max()
    if torch.is_tensor(idx) and idx.dim() == 1:
        idx = idx.to(device=ck.device, dtype=torch.int64)
        rows = torch.arange(b, device=ck.device)
        _write_rows(ck, rows, idx, k[:, 0])
        _write_rows(cv, rows, idx, v[:, 0])
        valid = (idx + 1).to(torch.int32)
    else:
        i = min(max(int(idx), 0), ck.shape[1] - 1)
        ck[:, i] = k[:, 0].to(ck.dtype)
        cv[:, i] = v[:, 0].to(cv.dtype)
        valid = torch.full((b,), i + 1, dtype=torch.int32, device=ck.device)
    if cfg.decode_impl == "cuda":
        from repro_torch import kernels

        out = kernels.decode_attention(q, ck, cv, valid,
                                       softmax_mode=cfg.softmax_mode)
    elif cfg.decode_impl == "chunked":
        out = _inner_attention(q, ck.to(q.dtype), cv.to(q.dtype), cfg,
                               causal=False, kv_valid_len=valid)
    else:
        raise ValueError(f"decode_impl must be chunked or cuda, got "
                         f"{cfg.decode_impl!r}")
    return _out_proj(params, cfg, out), cache


def make_kv_cache(cfg: LMConfig, batch: int, max_len: int, n_layers: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """Stacked (layers-first) KV cache: k, v (L, B, T, K, D), zeros."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

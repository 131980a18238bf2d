"""Attention: GQA/MHA with RoPE, qk-norm, qkv-bias, cross-attention and a
dense KV cache.

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
rows into the cache tensors it is given and returns the same dict.

int8 caches (``repro_torch.serving.pages``): a cache dict that carries
``k_scale`` / ``v_scale`` leaves holds int8 rows with one float32 scale per
row.  Writes quantize the fresh rows (:func:`quantize_kv_rows`), reads
dequantize them (:func:`dequantize_kv`, or the ``decode_attention`` kernel
on read), so the resident cache stays int8.  Paged decode
(``paged_tables``) takes the page pool's leaves (n_pages, page, K, D) and
per-slot tables; the fresh row goes straight into its page and the
``decode_attention`` kernel reads the pages through the tables.
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
# (position) row of K and of V (the page pool stores them).
KV_QUANT_MAX = 127.0
KV_QUANT_EPS = 1e-8


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
    host synchronisation.  ``cache`` is (B, T, ...) and ``new`` (B, ...)."""
    t = cache.shape[1]
    ok = (idx >= 0) & (idx < t)
    idx_c = idx.clamp(0, t - 1)
    keep = cache[rows, idx_c]
    ok = ok.view((-1,) + (1,) * (new.dim() - 1))
    cache[rows, idx_c] = torch.where(ok, new.to(cache.dtype), keep)


def put_rows(dst: torch.Tensor, index: Tuple[torch.Tensor, ...],
             ok: torch.Tensor, rows: torch.Tensor) -> None:
    """``dst[index[0][i], index[1][i], ...] = rows[i]`` in place for every
    i with ``ok[i]``; the other rows are dropped (the reference's
    ``mode="drop"`` scatter to a sentinel), without a host
    synchronisation.  A dropped row is written as a copy of the first kept
    row's write (the same bytes to the same place), or, when no row is
    kept, as ``dst[0, ..., 0]`` onto itself: indices that repeat carry
    equal values, so the result does not depend on the order in which the
    device performs the writes.  ``dst`` may be a view (a ``movedim`` of
    a pool leaf): the writes land in its storage."""
    any_ok = ok.any()
    # the first kept row (row 0 when none is), as a (1,) index: indexing
    # with a 0-d tensor would read it on the host
    first = torch.argmax(ok.to(torch.int32)).view(1)
    tgt = tuple(torch.where(ok, i, torch.where(
        any_ok, i.index_select(0, first), torch.zeros_like(i[:1])))
        for i in index)
    src = rows.to(dst.dtype)
    fill = torch.where(any_ok, src.index_select(0, first),
                       dst[(0,) * len(index)][None])
    shape = (-1,) + (1,) * (src.dim() - 1)
    dst.index_put_(tgt, torch.where(ok.view(shape), src, fill))


def page_slot(tables: torch.Tensor, pos: torch.Tensor, page: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where row ``pos[b]`` of slot b lives in the pool: (page id from the
    table, unclipped; row within the page; whether the row is written).
    A row is dropped when its table entry is negative (an unmapped page)
    or when it lies past the table."""
    b, p_per = tables.shape
    pos = pos.to(torch.int64)
    pid = tables[torch.arange(b, device=tables.device),
                 (pos // page).clamp(0, p_per - 1)].to(torch.int64)
    ok = (pid >= 0) & (pos >= 0) & (pos < p_per * page)
    return pid, pos % page, ok


def _paged_decode(params, cfg: LMConfig, q, k, v, cache, idx, tables):
    """Decode one token against *pool-shaped* cache leaves.

    ``cache`` holds the page pool's leaves of one layer, k / v
    (n_pages, page, K, D) (int8 plus ``k_scale`` / ``v_scale``
    (n_pages, page) when quantized), and ``tables`` (B, P) maps each
    slot's page index to a pool page (negative = unmapped).  The fresh
    row is written in place into its page (rows of unmapped pages, and
    rows past the table, are dropped), then the ``decode_attention``
    kernel reads the slot's pages through its table row: no gathered
    dense view.
    """
    from repro_torch import kernels

    b = q.shape[0]
    ck, cv = cache["k"], cache["v"]
    n_pages, page = ck.shape[0], ck.shape[1]
    tables = tables.to(device=ck.device)
    idx = idx.to(device=ck.device, dtype=torch.int64)
    pid, off, ok = page_slot(tables, idx, page)
    at = (pid.clamp(0, n_pages - 1), off)
    if "k_scale" in cache:
        kq, ks = quantize_kv_rows(k[:, 0])
        vq, vs = quantize_kv_rows(v[:, 0])
        put_rows(ck, at, ok, kq)
        put_rows(cv, at, ok, vq)
        put_rows(cache["k_scale"], at, ok, ks)
        put_rows(cache["v_scale"], at, ok, vs)
        ks_arg, vs_arg = cache["k_scale"], cache["v_scale"]
    else:
        put_rows(ck, at, ok, k[:, 0])
        put_rows(cv, at, ok, v[:, 0])
        ks_arg = vs_arg = None
    valid = (idx + 1).to(torch.int32)
    out = kernels.decode_attention(q, ck, cv, valid, tables=tables,
                                   ks=ks_arg, vs=vs_arg,
                                   softmax_mode=cfg.softmax_mode)
    return _out_proj(params, cfg, out), cache


def self_attention(params, cfg: LMConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: Any = None,
                   prefill_offset: int = 0,
                   paged_tables=None,
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention with an optional KV cache (updated in place).

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
                                       With ``paged_tables`` (B, P) the cache
                                       leaves are the page pool's.

    A cache with ``k_scale`` / ``v_scale`` leaves is int8: fresh rows are
    quantized on write and the cached rows dequantized on read.
    """
    q, k, v = _project_qkv(params, cfg, x, x)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _inner_attention(q, k, v, cfg, causal=cfg.causal)
        return _out_proj(params, cfg, out), None

    quant = "k_scale" in cache
    ck, cv = cache["k"], cache["v"]
    s = x.shape[1]
    off = int(prefill_offset)
    if s > 1:
        if off and not cfg.causal:
            raise ValueError("continuation prefill requires a causal model")
        if off + s > ck.shape[1]:
            raise ValueError(f"prefill rows [{off}, {off + s}) pass the "
                             f"cache length {ck.shape[1]}")
        if quant:
            kq, ks = quantize_kv_rows(k)
            vq, vs = quantize_kv_rows(v)
            ck[:, off:off + s] = kq
            cv[:, off:off + s] = vq
            cache["k_scale"][:, off:off + s] = ks
            cache["v_scale"][:, off:off + s] = vs
        else:
            ck[:, off:off + s] = k.to(ck.dtype)
            cv[:, off:off + s] = v.to(cv.dtype)
        if off:
            t = off + s
            if quant:
                kk = dequantize_kv(ck[:, :t], cache["k_scale"][:, :t], q.dtype)
                vv = dequantize_kv(cv[:, :t], cache["v_scale"][:, :t], q.dtype)
            else:
                # rows [0, t) of a longer cache are a strided view; the
                # flash kernel reads contiguous K/V
                kk = ck[:, :t].to(q.dtype).contiguous()
                vv = cv[:, :t].to(q.dtype).contiguous()
            out = _inner_attention(q, kk, vv, cfg, causal=True, q_offset=off)
        else:
            out = _inner_attention(q, k, v, cfg, causal=cfg.causal)
        return _out_proj(params, cfg, out), cache

    b = x.shape[0]
    idx = cache_index if cache_index is not None else positions[:, 0].max()
    vector = torch.is_tensor(idx) and idx.dim() == 1
    if paged_tables is not None:
        if not vector:
            raise ValueError("paged decode requires a vector cache_index")
        return _paged_decode(params, cfg, q, k, v, cache, idx, paged_tables)
    if vector:
        idx = idx.to(device=ck.device, dtype=torch.int64)
        rows = torch.arange(b, device=ck.device)
        if quant:
            kq, ks = quantize_kv_rows(k[:, 0])
            vq, vs = quantize_kv_rows(v[:, 0])
            _write_rows(ck, rows, idx, kq)
            _write_rows(cv, rows, idx, vq)
            _write_rows(cache["k_scale"], rows, idx, ks)
            _write_rows(cache["v_scale"], rows, idx, vs)
        else:
            _write_rows(ck, rows, idx, k[:, 0])
            _write_rows(cv, rows, idx, v[:, 0])
        valid = (idx + 1).to(torch.int32)
    else:
        if quant:
            raise ValueError(
                "quantized cache decode requires a vector cache_index")
        i = min(max(int(idx), 0), ck.shape[1] - 1)
        ck[:, i] = k[:, 0].to(ck.dtype)
        cv[:, i] = v[:, 0].to(cv.dtype)
        valid = torch.full((b,), i + 1, dtype=torch.int32, device=ck.device)
    scales = ({"ks": cache["k_scale"], "vs": cache["v_scale"]} if quant
              else {})
    if cfg.decode_impl == "cuda":
        # the cache stays resident: int8 stays int8 and is dequantized on
        # read inside the kernel
        from repro_torch import kernels

        out = kernels.decode_attention(q, ck, cv, valid,
                                       softmax_mode=cfg.softmax_mode,
                                       **scales)
    elif cfg.decode_impl == "chunked":
        if quant:
            kk = dequantize_kv(ck, scales["ks"], q.dtype)
            vv = dequantize_kv(cv, scales["vs"], q.dtype)
        else:
            kk, vv = ck.to(q.dtype), cv.to(q.dtype)
        out = _inner_attention(q, kk, vv, cfg, causal=False,
                               kv_valid_len=valid)
    else:
        raise ValueError(f"decode_impl must be chunked or cuda, got "
                         f"{cfg.decode_impl!r}")
    return _out_proj(params, cfg, out), cache


def cross_attention(params, cfg: LMConfig, x: torch.Tensor,
                    kv_feats: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Cross-attention onto (precomputed) image features, output gated by
    ``tanh(gate)``.

    With ``kv_feats`` the K/V are projected from them (and written in place
    into ``cache`` when one is given); with a cache and no ``kv_feats``
    (decode, or a prompt without an image) the cached K/V are read.  The
    attention is non-causal: a prefill (S > 1) with ``attn_impl ==
    "cuda"`` runs the ``flash_attention`` kernel, the one-token decode step
    the chunked path, as in self-attention.
    """
    cd = cfg.cdtype()
    if cache is not None and kv_feats is None:
        k, v = cache["k"].to(cd), cache["v"].to(cd)
        q = torch.einsum("bsd,dhk->bshk", x.to(cd), params["wq"].to(cd))
        if cfg.qkv_bias:
            q = q + params["bq"].to(cd)
        if cfg.qk_norm:
            q = common.rms_norm_simple(q) * params["q_norm"].to(cd)
    else:
        q, k, v = _project_qkv(params, cfg, x, kv_feats)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    out = _inner_attention(q, k, v, cfg, causal=False)
    y = _out_proj(params, cfg, out)
    return y * torch.tanh(params["gate"].to(y.dtype)), cache


def make_kv_cache(cfg: LMConfig, batch: int, max_len: int, n_layers: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """Stacked (layers-first) KV cache: k, v (L, B, T, K, D), zeros."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

"""Oracles of the attention kernels: exact GQA attention in float32.

The same functions as the reference's oracles, dense, int8 and paged
branches included; the kernels' parity checks hold them against these.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, K, D); H = K * G -> (B, S, H, D)."""
    b, s, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = h // nkv
    qg = q.reshape(b, s, nkv, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None, None]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def attention_dequant_ref(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          vq: torch.Tensor, vs: torch.Tensor,
                          causal: bool = True, q_offset: int = 0
                          ) -> torch.Tensor:
    """Dequantize int8 K/V rows (``kq``/``vq`` (B, T, K, D) with per-row
    scales ``ks``/``vs`` (B, T)), then exact float32 attention."""
    k = kq.float() * ks[..., None, None]
    v = vq.float() * vs[..., None, None]
    return attention_ref(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid_len: torch.Tensor, tables=None,
                         ks=None, vs=None) -> torch.Tensor:
    """Oracle of the q_len = 1 decode kernel.

    Dense cache: q (B, 1, H, D); k/v (B, T, K, D); optional ``ks``/``vs``
    (B, T) per-row scales when k/v are int8.

    Paged cache: k/v are pool leaves (n_pages, page, K, D) and ``tables``
    (B, P) maps each slot's page index to a pool page; optional scales are
    the pool scale leaves (n_pages, page).  Negative table entries address
    page 0 after clipping and rely on ``kv_valid_len`` masking.

    Rows with ``kv_valid_len <= 0`` return zeros.
    """
    b, s, h, d = q.shape
    if tables is not None:
        n_pages, page = k.shape[0], k.shape[1]
        tv = torch.clamp(tables.long(), 0, n_pages - 1)
        per_slot = tv.shape[1] * page
        k = k[tv].reshape(b, per_slot, k.shape[2], k.shape[3])
        v = v[tv].reshape(b, per_slot, v.shape[2], v.shape[3])
        if ks is not None:
            ks = ks[tv].reshape(b, per_slot)
            vs = vs[tv].reshape(b, per_slot)
    if ks is not None:
        k = k.float() * ks[..., None, None]
        v = v.float() * vs[..., None, None]
    t, nkv = k.shape[1], k.shape[2]
    g = h // nkv
    qg = q.reshape(b, s, nkv, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    valid = kv_valid_len.to(device=q.device, dtype=torch.int64)
    mask = (torch.arange(t, device=q.device)[None, :]
            < valid[:, None])[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", e, v.float())
    den = torch.clamp(e.sum(dim=-1), min=1e-30)          # (b, k, g, s)
    out = out / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)

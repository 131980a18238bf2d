"""xLSTM blocks: mLSTM (matrix memory, chunked) and sLSTM (scalar memory,
a scan over time), Beck et al. 2024, arXiv:2405.04517.

mLSTM cell (per head, exponential gating, stabiliser m):

    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t - m_t) v_t k_t^T
    n_t = exp(logf_t + m_{t-1} - m_t) n_{t-1} + exp(logi_t - m_t) k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))

The chunked form uses the row maximum over the intra-chunk weights and the
carried state's weight as its stabiliser, clamped at -1e30 so that an
empty row gives no NaN; the chunk is the reference's (``chunk_size``
halved until it divides S).  The reference scans the whole chunk body
with ``lax.scan``.  Eagerly, the terms that do not read the carry (the
intra-chunk weights and their maxima) are computed for all chunks in one
batched pass, the Python loop carries (C, n, m) and records what each
chunk's queries read of the carry entering it (q C, q n, m), and the
outputs of all chunks follow in one batched pass.  Each chunk's arithmetic
is the reference's; an odd S (Q = 1) still costs S iterations of the loop.
A one-token step (decode) takes :func:`_mlstm_step`.

sLSTM keeps a scalar memory with a recurrent weight on h_{t-1}, so it is a
loop over time; a fresh state starts at m = -1e30.  Training differentiates
both blocks by eager autograd through these loops.  The reference gives its
sLSTM scan a custom VJP that replays the forward and forms the recurrent
weight's gradient in one einsum after the scan (one reduction on a sharded
batch); autograd accumulates it step by step instead, which the unsharded
port does not pay for, and computes the same gradients.  The stabilisers
give no NaN gradient: a fresh m of -1e30 (sLSTM) or -inf (mLSTM) enters
only through ``exp`` terms that are exactly 0 with a zero derivative, and
the -1e30 clamp of the mLSTM's row maximum passes its gradient to the
larger argument.

Plain PyTorch, as the reference is plain ``jnp``: no kernel.  As in the
reference, the mLSTM's ``w_gates`` / ``b_gates`` and ``norm_scale`` and
all of the sLSTM's gate parameters (``w_gates``, ``b_gates``,
``r_gates``) and its ``norm_scale`` are read in float32 (``lm.compute_params``
keeps them in the parameter type).  States are float32; the functions
return new states, which ``lm.forward`` writes into the cache in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (LMConfig, ParamDef, activation,
                                       fanin_init, ones_init, zeros_init)
from repro_torch.models.mamba2 import _causal_conv, _chunked, chunk_len

NEG_BIG = -1e30


def _xl(cfg: LMConfig):
    if cfg.xlstm is None:
        raise ValueError(f"{cfg.arch_id}: no xlstm config")
    return cfg.xlstm


def slstm_every(cfg: LMConfig) -> int:
    """Blocks of an ssm unit: ``slstm_every - 1`` mLSTM, then one sLSTM."""
    return _xl(cfg).slstm_every


def _gate_bias_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    half = shape[0] // 2
    return torch.cat([
        torch.full((half,), -3.0, dtype=torch.float32, device=gen.device),
        torch.linspace(3.0, 6.0, half, dtype=torch.float32,
                       device=gen.device)]).to(dtype)   # igate, fgate


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_inner(cfg: LMConfig) -> int:
    return int(_xl(cfg).mlstm_proj_factor * cfg.d_model)


def mlstm_defs(cfg: LMConfig) -> Dict[str, Any]:
    x = _xl(cfg)
    d = cfg.d_model
    di = mlstm_inner(cfg)
    nh = cfg.n_heads
    hd = di // nh
    return {
        "up_proj": ParamDef((d, 2 * di), ("embed", "mlstm_up"), fanin_init(d)),
        "conv_w": ParamDef((x.d_conv, di), (None, "mlstm_inner"),
                           fanin_init(x.d_conv)),
        "conv_b": ParamDef((di,), ("mlstm_inner",), zeros_init()),
        "wq": ParamDef((di, nh, hd), ("mlstm_inner", "heads", "head_dim"),
                       fanin_init(di)),
        "wk": ParamDef((di, nh, hd), ("mlstm_inner", "heads", "head_dim"),
                       fanin_init(di)),
        "wv": ParamDef((di, nh, hd), ("mlstm_inner", "heads", "head_dim_v"),
                       fanin_init(di)),
        "w_gates": ParamDef((di, 2 * nh), ("mlstm_inner", None),
                            fanin_init(di)),
        "b_gates": ParamDef((2 * nh,), (None,), _gate_bias_init),
        "norm_scale": ParamDef((di,), ("mlstm_inner",), ones_init()),
        "skip_scale": ParamDef((di,), ("mlstm_inner",), ones_init()),
        "down_proj": ParamDef((di, d), ("mlstm_inner", "embed_tp"),
                              fanin_init(di)),
    }


Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _mlstm_chunked(q, k, v, logi, logf, chunk: int,
                   carry: Optional[Carry] = None
                   ) -> Tuple[torch.Tensor, Carry]:
    """q, k (B, S, H, Dk); v (B, S, H, Dv); logi / logf (B, S, H).

    Returns (h (B, S, H, Dv) in q's type, (C, n, m) the final carry)."""
    bsz, s, nh, dk = q.shape
    dv = v.shape[-1]
    qc = chunk_len(chunk, s)
    nc = s // qc

    q_c = _chunked(q.float() / math.sqrt(dk), nc, qc)
    k_c, v_c = _chunked(k.float(), nc, qc), _chunked(v.float(), nc, qc)
    li_c, lf_c = _chunked(logi.float(), nc, qc), _chunked(logf.float(), nc, qc)

    dev = q.device
    if carry is None:
        c_p = torch.zeros((bsz, nh, dk, dv), dtype=torch.float32, device=dev)
        n_p = torch.zeros((bsz, nh, dk), dtype=torch.float32, device=dev)
        m_p = torch.full((bsz, nh), float("-inf"), dtype=torch.float32,
                         device=dev)
    else:
        c_p, n_p, m_p = (t.float() for t in carry)

    # every term that does not read the carry, for all chunks at once
    # (index c: the chunk)
    idx = torch.arange(qc, device=dev)
    tri = (idx[:, None] >= idx[None, :])[:, :, None]        # (i, j, 1): j <= i
    cum = torch.cumsum(lf_c, dim=2)                          # (nc, B, Q, H)
    w = (cum[:, :, :, None, :] - cum[:, :, None, :, :]
         + li_c[:, :, None, :, :])                           # (nc, B, i, j, H)
    w = torch.where(tri, w, float("-inf"))
    m_intra = w.amax(dim=3)                                  # (nc, B, i, H)
    total = cum[:, :, -1, :]                                 # (nc, B, H)
    up_w = total[:, :, None, :] - cum + li_c                 # (nc, B, j, H)
    up_max = up_w.amax(dim=2)                                # (nc, B, H)
    # the scan: the carry entering each chunk, read by that chunk's queries
    m_in, qc_in, qn_in = [], [], []
    for n in range(nc):
        m_in.append(m_p)
        qc_in.append(torch.einsum("bihd,bhdv->bihv", q_c[n], c_p))
        qn_in.append(torch.einsum("bihd,bhd->bih", q_c[n], n_p))
        m_new = torch.clamp(torch.maximum(total[n] + m_p, up_max[n]),
                            min=NEG_BIG)
        scale_old = torch.exp(total[n] + m_p - m_new)        # (B, H)
        w_j = torch.exp(up_w[n] - m_new[:, None, :])         # (B, j, H)
        kw = k_c[n] * w_j[..., None]
        c_p = (c_p * scale_old[:, :, None, None]
               + torch.einsum("bjhd,bjhv->bhdv", kw, v_c[n]))
        n_p = n_p * scale_old[:, :, None] + kw.sum(dim=1)
        m_p = m_new
    # the outputs of all chunks, stabilised by the row maximum over the
    # intra-chunk weights and the carried state's weight
    m_inter = cum + torch.stack(m_in)[:, :, None, :]         # (nc, B, i, H)
    m_i = torch.clamp(torch.maximum(m_intra, m_inter), min=NEG_BIG)
    d_mat = torch.exp(w - m_i[:, :, :, None, :])             # (nc, B, i, j, H)
    scores = torch.einsum("cbihd,cbjhd->cbijh", q_c, k_c) * d_mat
    inter_w = torch.exp(m_inter - m_i)                       # (nc, B, i, H)
    numer = (torch.einsum("cbijh,cbjhv->cbihv", scores, v_c)
             + inter_w[..., None] * torch.stack(qc_in))
    denom = scores.sum(dim=3) + inter_w * torch.stack(qn_in)
    h = numer / torch.maximum(denom.abs(), torch.exp(-m_i))[..., None]
    h = h.transpose(0, 1).reshape(bsz, s, nh, dv)
    return h.to(q.dtype), (c_p, n_p, m_p)


def _mlstm_step(q, k, v, logi, logf, carry: Carry
                ) -> Tuple[torch.Tensor, Carry]:
    """One token.  q, k (B, H, Dk); v (B, H, Dv); logi / logf (B, H)."""
    c_p, n_p, m_p = carry
    dk = q.shape[-1]
    qf = q.float() / math.sqrt(dk)
    m_new = torch.maximum(logf + m_p, logi)
    scale_old = torch.exp(logf + m_p - m_new)
    w_new = torch.exp(logi - m_new)
    kw = k * w_new[..., None]                    # float32 (k widened)
    c_n = (c_p * scale_old[..., None, None]
           + torch.einsum("bhd,bhv->bhdv", kw, v.float()))
    n_n = n_p * scale_old[..., None] + kw
    numer = torch.einsum("bhd,bhdv->bhv", qf, c_n)
    denom = torch.einsum("bhd,bhd->bh", qf, n_n)
    h = numer / torch.maximum(denom.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (c_n, n_n, m_new)


def _group_norm_heads(h: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS norm of (B, S, H, Dv) folded to (B, S, di), times
    ``scale`` (float32)."""
    hf = h.float()
    hf = hf * torch.rsqrt(hf.square().mean(dim=-1, keepdim=True) + eps)
    b, s = h.shape[0], h.shape[1]
    return (hf.reshape(b, s, -1) * scale.float()).to(h.dtype)


def mlstm_apply(params: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """mLSTM block body (the caller adds the residual): x (B, S, d_model)
    -> (B, S, d_model).  ``state`` ``{"c", "n", "m", "conv"}`` for
    incremental use; None starts fresh and returns no state."""
    xl = _xl(cfg)
    cd = cfg.cdtype()
    s = x.shape[1]

    up = x.to(cd) @ params["up_proj"].to(cd)               # (B, S, 2di)
    inner, z = up.chunk(2, dim=-1)
    conv_state = None if state is None else state["conv"]
    conv_out, new_conv = _causal_conv(inner, params["conv_w"].to(cd),
                                      params["conv_b"].to(cd), conv_state)

    q = torch.einsum("bsd,dhk->bshk", conv_out, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", conv_out, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", inner, params["wv"].to(cd))
    gates = inner.float() @ params["w_gates"].float() \
        + params["b_gates"].float()
    logi, f_raw = gates.chunk(2, dim=-1)                   # (B, S, H) each
    logf = F.logsigmoid(f_raw)

    if state is None:
        h, _ = _mlstm_chunked(q, k, v, logi, logf, xl.chunk_size)
        new_state = None
    else:
        carry = (state["c"], state["n"], state["m"])
        if s == 1:
            h, carry = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], logi[:, 0],
                                   logf[:, 0], carry)
            h = h[:, None]
        else:
            h, carry = _mlstm_chunked(q, k, v, logi, logf, xl.chunk_size,
                                      carry)
        new_state = {"c": carry[0], "n": carry[1], "m": carry[2],
                     "conv": new_conv}
    hn = _group_norm_heads(h, params["norm_scale"])
    hn = hn + conv_out * params["skip_scale"].to(cd)       # learnable skip
    out = (hn * F.silu(z.float()).to(cd)) @ params["down_proj"].to(cd)
    return out, new_state


def mlstm_state_shapes(cfg: LMConfig, batch: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    xl = _xl(cfg)
    di = mlstm_inner(cfg)
    nh = cfg.n_heads
    hd = di // nh
    f32 = torch.float32
    return {"c": ((batch, nh, hd, hd), f32), "n": ((batch, nh, hd), f32),
            "m": ((batch, nh), f32),
            "conv": ((batch, xl.d_conv - 1, di), f32)}


def mlstm_state_specs() -> Dict[str, Tuple[Optional[str], ...]]:
    return {"c": ("batch", "heads", None, "head_dim_v"),
            "n": ("batch", "heads", None),
            "m": ("batch", "heads"),
            "conv": ("batch", None, "mlstm_inner")}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(cfg: LMConfig) -> Dict[str, Any]:
    xl = _xl(cfg)
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dff = int(xl.slstm_ff_factor * d)
    dff = ((dff + 63) // 64) * 64            # a multiple of 64, as the reference
    return {
        "w_gates": ParamDef((d, 4 * nh * hd), ("embed", "slstm_gates"),
                            fanin_init(d)),
        "r_gates": ParamDef((nh, hd, 4 * hd), ("heads", None, None),
                            fanin_init(hd)),
        "b_gates": ParamDef((4 * nh * hd,), ("slstm_gates",), zeros_init()),
        "norm_scale": ParamDef((d,), (None,), ones_init()),
        "ff_up": ParamDef((d, 2 * dff), ("embed", "mlp"), fanin_init(d)),
        "ff_down": ParamDef((dff, d), ("mlp", "embed_tp"), fanin_init(dff)),
    }


SState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _slstm_cell(gates: torch.Tensor, st: SState) -> SState:
    """gates (B, H, 4*hd) laid out [i, f, z, o]; state (c, n, m, h)."""
    c_p, n_p, m_p, _ = st
    i_r, f_r, z_r, o_r = gates.chunk(4, dim=-1)            # (B, H, hd)
    logi = i_r
    logf = F.logsigmoid(f_r)
    m_new = torch.maximum(logf + m_p, logi)
    keep = torch.exp(logf + m_p - m_new)
    write = torch.exp(logi - m_new)
    c_n = keep * c_p + write * torch.tanh(z_r)
    n_n = keep * n_p + write
    h_n = torch.sigmoid(o_r) * c_n / torch.clamp(n_n, min=1e-6)
    return (c_n, n_n, m_new, h_n)


def _slstm_scan(wx: torch.Tensor, r: torch.Tensor, st: SState
                ) -> Tuple[torch.Tensor, SState]:
    """wx (B, S, H, 4hd); r (H, hd, 4hd) -> (h (B, S, H, hd), final state)."""
    hs = []
    for t in range(wx.shape[1]):
        rec = torch.einsum("bhd,hde->bhe", st[3], r)
        st = _slstm_cell(wx[:, t] + rec, st)
        hs.append(st[3])
    return torch.stack(hs, dim=1), st


def slstm_apply(params: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """sLSTM block body: the scan over time and the gated FFN.  ``state``
    ``{"c", "n", "m", "h"}`` for incremental use; None starts fresh
    (m = -1e30) and returns no state."""
    cd = cfg.cdtype()
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    bsz, s = x.shape[0], x.shape[1]

    wx = (x.float() @ params["w_gates"].float()
          + params["b_gates"].float()).reshape(bsz, s, nh, 4 * hd)
    if state is None:
        zeros = torch.zeros((bsz, nh, hd), dtype=torch.float32,
                            device=x.device)
        st0 = (zeros, zeros, torch.full_like(zeros, NEG_BIG), zeros)
    else:
        st0 = (state["c"], state["n"], state["m"], state["h"])
    h, st_f = _slstm_scan(wx, params["r_gates"].float(), st0)
    h = h.reshape(bsz, s, d)

    # the block's group norm, then the gated FFN
    hf = h.float()
    h = (hf * torch.rsqrt(hf.square().mean(dim=-1, keepdim=True) + 1e-5)
         * params["norm_scale"].float()).to(cd)
    a, b = (h @ params["ff_up"].to(cd)).chunk(2, dim=-1)
    out = (activation("gelu")(a) * b) @ params["ff_down"].to(cd)

    new_state = None
    if state is not None:
        new_state = {"c": st_f[0], "n": st_f[1], "m": st_f[2], "h": st_f[3]}
    return out, new_state


def slstm_state_shapes(cfg: LMConfig, batch: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    nh = cfg.n_heads
    shape = ((batch, nh, cfg.d_model // nh), torch.float32)
    return {"c": shape, "n": shape, "m": shape, "h": shape}


def slstm_state_specs() -> Dict[str, Tuple[Optional[str], ...]]:
    ax = ("batch", "heads", None)
    return {"c": ax, "n": ax, "m": ax, "h": ax}

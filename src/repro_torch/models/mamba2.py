"""Mamba-2 (SSD) block: the chunked scan and its O(1) decode step.

State-space duality (Dao & Gu 2024).  Per head h with the scalar decay
a_t = exp(dt_t * A_h), A_h < 0:

    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T        S: (d_state, head_dim)
    y_t = C_t^T S_t + D_h * x_t

The scan runs over chunks of Q positions (the reference's rule: Q =
``chunk_size``, halved until it divides S).  Within a chunk the work is
(Q x Q) einsums (segment decays L[i, j] = exp(cum[i] - cum[j]), j <= i);
across chunks the state is carried.  ``cum`` is the inclusive cumulative
sum of the log decays within the chunk.  The reference scans the whole
chunk body with ``lax.scan``.  Eagerly, every term that does not read the
carried state (the intra-chunk output, each chunk's own state increment
and decay) is computed for all chunks in one batched pass, and the Python
loop carries only the state (S_n = decay_n S_{n-1} + increment_n, two
operations a chunk); the output's inter-chunk term then reads the stacked
states in one einsum.  Each chunk's arithmetic is the reference's; an odd
S (Q = 1) still costs S iterations of that loop.

Plain PyTorch, as the reference is plain ``jnp``: the block has no kernel.
``a_log``, ``dt_bias``, ``d_skip`` and ``norm_scale`` are read in float32
at each use, as the reference reads them (``lm.compute_params`` keeps
them in the parameter type); the projections and the convolution in the
compute type.  The state is float32: ``{"ssm": (B, H, P, N), "conv":
(B, K-1, C)}``.  The functions here return new states; ``lm.forward``
writes them into the cache in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (LMConfig, ParamDef, fanin_init,
                                       ones_init, zeros_init)


def _ssm(cfg: LMConfig):
    if cfg.ssm is None:
        raise ValueError(f"{cfg.arch_id}: no ssm config")
    return cfg.ssm


def _a_log_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=torch.float32,
                                    device=gen.device)).to(dtype)


def mamba2_defs(cfg: LMConfig) -> Dict[str, Any]:
    s = _ssm(cfg)
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    ng, ds = s.n_groups, s.d_state
    # in_proj packs [z (di), x (di), B (ng*ds), C (ng*ds), dt (nh)]
    d_in_proj = 2 * di + 2 * ng * ds + nh
    return {
        "in_proj": ParamDef((d, d_in_proj), ("embed", "mamba_inner"),
                            fanin_init(d)),
        "conv_w": ParamDef((s.d_conv, di + 2 * ng * ds),
                           (None, "mamba_conv"), fanin_init(s.d_conv)),
        "conv_b": ParamDef((di + 2 * ng * ds,), ("mamba_conv",), zeros_init()),
        "a_log": ParamDef((nh,), ("heads",), _a_log_init),
        "dt_bias": ParamDef((nh,), ("heads",), zeros_init()),
        "d_skip": ParamDef((nh,), ("heads",), ones_init()),
        "norm_scale": ParamDef((di,), ("mamba_inner",), ones_init()),
        "out_proj": ParamDef((di, d), ("mamba_inner", "embed_tp"),
                             fanin_init(di)),
    }


def _split_in_proj(cfg: LMConfig, zxbcdt: torch.Tensor):
    s = _ssm(cfg)
    di = s.d_inner(cfg.d_model)
    ng, ds, nh = s.n_groups, s.d_state, s.n_heads(cfg.d_model)
    z, x, bc, dt = torch.split(zxbcdt, [di, di, 2 * ng * ds, nh], dim=-1)
    b, c = bc.chunk(2, dim=-1)
    return z, x, b, c, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution over time.  xbc (B, S, C); w (K, C).

    Returns (activated output, new conv state (B, K-1, C))."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                      # (B, S+K-1, C)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return F.silu(out + bias), new_state


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2 output norm: RMSNorm(x * silu(z)) * scale."""
    y = x * F.silu(z.float()).to(x.dtype)
    yf = y.float()
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def chunk_len(chunk: int, s: int) -> int:
    """The reference's chunk: ``min(chunk, s)`` halved until it divides
    ``s`` (1 for an odd ``s`` above the chunk)."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def _chunked(t: torch.Tensor, nc: int, q: int) -> torch.Tensor:
    """(B, S, ...) -> (nc, B, Q, ...), a view."""
    return t.reshape(t.shape[0], nc, q, *t.shape[2:]).transpose(0, 1)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                 chunk: int, init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (B, S, H, P); dt (B, S, H) softplus'd; b, c (B, S, G, N).

    Returns (y (B, S, H, P) in x's type, final state (B, H, P, N))."""
    bsz, s, nh, hd = x.shape
    ng, ds = b.shape[2], b.shape[3]
    rep = nh // ng
    q = chunk_len(chunk, s)
    nc = s // q
    a = -torch.exp(a_log.float())                          # (H,), negative
    loga = dt.float() * a                                  # (B, S, H)
    xf = x.float() * dt.float()[..., None]                 # fold dt into x

    x_c = _chunked(xf, nc, q)                              # (nc, B, Q, H, P)
    la_c = _chunked(loga, nc, q)                           # (nc, B, Q, H)
    b_c = _chunked(b.float(), nc, q)                       # (nc, B, Q, G, N)
    c_c = _chunked(c.float(), nc, q)

    if init_state is None:
        state = torch.zeros((bsz, nh, hd, ds), dtype=torch.float32,
                            device=x.device)
    else:
        state = init_state.float()

    # every term that does not read the carried state, for all chunks at
    # once (index c: the chunk)
    idx = torch.arange(q, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[:, :, None]      # (i, j, 1): j <= i
    cum = torch.cumsum(la_c, dim=2)                        # (nc, B, Q, H)
    cb = torch.einsum("cbigd,cbjgd->cbgij", c_c, b_c)      # (nc, B, G, Q, Q)
    cb = torch.repeat_interleave(cb, rep, dim=2)           # (nc, B, H, Q, Q)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (nc, B, i, j, H)
    dec = torch.where(tri, dec, float("-inf"))
    l_mat = torch.exp(dec).permute(0, 1, 4, 2, 3)          # (nc, B, H, i, j)
    y_intra = torch.einsum("cbhij,cbjhp->cbihp", cb * l_mat, x_c)
    total = cum[:, :, -1, :]                               # (nc, B, H)
    rem = torch.exp(total[:, :, None, :] - cum)            # (nc, B, Q, H)
    b_h = torch.repeat_interleave(b_c, rep, dim=3)         # (nc, B, Q, H, N)
    ds_new = torch.einsum("cbjhn,cbjhp->cbhpn", b_h * rem[..., None], x_c)
    decay = torch.exp(total)[..., None, None]              # (nc, B, H, 1, 1)
    # the scan: the state entering each chunk
    before = []
    for n in range(nc):
        before.append(state)
        state = state * decay[n] + ds_new[n]
    c_h = torch.repeat_interleave(c_c, rep, dim=3)         # (nc, B, Q, H, N)
    y_inter = torch.einsum("cbihn,cbhpn->cbihp",
                           c_h * torch.exp(cum)[..., None],
                           torch.stack(before))
    y = (y_intra + y_inter).transpose(0, 1).reshape(bsz, s, nh, hd)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def mamba2_apply(params: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Block forward.  x (B, S, d_model).

    ``state`` is ``{"ssm": (B, H, P, N), "conv": (B, K-1, C)}`` for
    incremental use (the new state is returned in its leaves' types); None
    starts from zeros and returns no state."""
    s = _ssm(cfg)
    cd = cfg.cdtype()
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    ng, ds = s.n_groups, s.d_state

    zxbcdt = x.to(cd) @ params["in_proj"].to(cd)
    z, xi, b, c, dt = _split_in_proj(cfg, zxbcdt)
    xbc = torch.cat([xi, b, c], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"].to(cd),
                                 params["conv_b"].to(cd), conv_state)
    xi, b, c = torch.split(xbc, [di, ng * ds, ng * ds], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    bsz, sl = x.shape[0], x.shape[1]
    xh = xi.reshape(bsz, sl, nh, di // nh)
    bg = b.reshape(bsz, sl, ng, ds)
    cg = c.reshape(bsz, sl, ng, ds)
    ssm_state = None if state is None else state["ssm"]
    y, new_ssm = _ssd_chunked(xh, dt, params["a_log"], bg, cg,
                              params["d_skip"], s.chunk_size, ssm_state)
    y = _gated_rmsnorm(y.reshape(bsz, sl, di), z, params["norm_scale"])
    out = y.to(cd) @ params["out_proj"].to(cd)
    new_state = None
    if state is not None:
        new_state = {"ssm": new_ssm.to(state["ssm"].dtype),
                     "conv": new_conv.to(state["conv"].dtype)}
    return out, new_state


def mamba2_state_shapes(cfg: LMConfig, batch: int
                        ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, type) of each leaf of one layer's incremental state."""
    s = _ssm(cfg)
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return {"ssm": ((batch, nh, di // nh, s.d_state), torch.float32),
            "conv": ((batch, s.d_conv - 1, di + 2 * s.n_groups * s.d_state),
                     torch.float32)}


def mamba2_init_state(cfg: LMConfig, batch: int,
                      device: Any = "cpu") -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in mamba2_state_shapes(cfg, batch).items()}


def mamba2_state_specs() -> Dict[str, Tuple[Optional[str], ...]]:
    return {"ssm": ("batch", "heads", None, None),
            "conv": ("batch", None, "mamba_conv")}

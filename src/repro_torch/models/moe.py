"""Fine-grained Mixture-of-Experts with shared experts (DeepSeekMoE / DBRX).

Dispatch is per batch row: each row top-k routes its S tokens and gathers
them into capacity-padded (E, C, d) expert buffers.  Capacity is per row
(GShard per-group capacity): C = ceil(S·k/E · cf), rounded up to a multiple
of 8.  Overflow tokens are dropped, in arrival order over (S, k).  The
capacity factor is a /1024 rational, so the static (Python) and per-row
(tensor) capacity computations are the same integer formula.

Ragged batches: ``moe_apply`` takes an optional ``token_mask`` (B, S)
marking real tokens.  The buffer stays sized by the padded S, but masked
tokens neither route nor consume capacity, and each row's *effective*
capacity is recomputed from its real token count, so a prompt prefilled in
a right-padded ragged batch sees the drops it would see prefilled alone.

Two dispatches compute the same function: ``onehot`` (the default; GShard
dispatch and combine as einsums over one-hot tensors, no scatter, so it is
repeatable bit for bit on the card) and ``scatter`` (per-row stable sort and
``index_add_``; the float ``index_add_`` of the combine is not deterministic
on CUDA).  The expert products are plain batched matmuls: the reference
computes them outside any kernel, so no kernel is owed.  The reference's
sharding constraints are left out until the port shards.

Ties: the top-k is a stable descending sort, so equal router logits pick
the lower expert id first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (LMConfig, ParamDef, activation,
                                       fanin_init, zeros_init)


def _cf_q(moe) -> int:
    """``capacity_factor`` as a /1024 rational numerator (>= 1)."""
    return max(1, int(round(moe.capacity_factor * 1024)))


def _capacity(seq: int, moe) -> int:
    den = 1024 * moe.n_experts
    c = (seq * moe.top_k * _cf_q(moe) + den - 1) // den
    return max(8, ((c + 7) // 8) * 8)


def _capacity_dyn(n_real: torch.Tensor, moe) -> torch.Tensor:
    """Per-row effective capacity from real token counts: the integer
    formula of :func:`_capacity` on a tensor."""
    den = 1024 * moe.n_experts
    c = (n_real.to(torch.int64) * moe.top_k * _cf_q(moe) + den - 1) // den
    return torch.clamp(((c + 7) // 8) * 8, min=8)


def moe_defs(cfg: LMConfig) -> Dict[str, Any]:
    assert cfg.moe is not None
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    defs: Dict[str, Any] = {
        "router": ParamDef((d, e), ("embed", None), fanin_init(d)),
        # additive router bias; expert pruning drives dead experts to -1e9
        "router_b": ParamDef((e,), (None,), zeros_init()),
        "wi": ParamDef((e, d, f), ("expert", "embed", "expert_mlp"),
                       fanin_init(d)),
        "wg": ParamDef((e, d, f), ("expert", "embed", "expert_mlp"),
                       fanin_init(d)),
        "wo": ParamDef((e, f, d), ("expert", "expert_mlp", "embed"),
                       fanin_init(f)),
    }
    if m.n_shared:
        # the shared experts form one fused dense FFN
        defs["shared"] = mlp_lib.mlp_defs(cfg, d_ff=m.n_shared * f)
    return defs


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last axis and their ids, ties to the
    lower id (a stable descending sort)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route_row(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, E) float32 logits -> (S, k) weights (softmax over the top-k), ids."""
    vals, ids = top_k(logits, k)
    return torch.softmax(vals, dim=-1), ids


def expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """int64 (n_experts + 1,) count of each id in ``flat_e``, the sentinel
    id ``n_experts`` in the last slot: ``torch.bincount`` with ``minlength``
    n_experts + 1, as a ``scatter_add_`` of ones, which has a meta kernel
    (the dry run) and is exact in int64 on the card."""
    ones = torch.ones_like(flat_e, dtype=torch.int64)
    return torch.zeros(n_experts + 1, dtype=torch.int64,
                       device=flat_e.device).scatter_add_(0, flat_e, ones)


def _dispatch_row(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                  n_experts: int, capacity: int,
                  mask: Optional[torch.Tensor] = None,
                  cap_row: Any = None):
    """One batch row: gather tokens into (E, C, d) capacity buffers.

    x: (S, d); ids / w: (S, k).  ``mask`` (S,) marks real tokens: masked
    tokens take the sentinel expert id E (the stable sort puts them last,
    the counts and the scatter drop them).  ``cap_row`` is the row's
    effective capacity (<= ``capacity``); None means the full buffer.
    Returns (dispatched (E*C, d), combine indices (E*C for a dropped
    slot), sorted token ids, sorted weights·keep)."""
    s, k = ids.shape
    dev = x.device
    flat_e = ids.reshape(-1)
    if mask is not None:
        flat_e = torch.where(mask.repeat_interleave(k), flat_e,
                             torch.full_like(flat_e, n_experts))
    flat_t = torch.arange(s, device=dev).repeat_interleave(k)
    flat_w = w.reshape(-1)

    order = torch.sort(flat_e, stable=True).indices
    e_sorted, t_sorted, w_sorted = flat_e[order], flat_t[order], flat_w[order]
    counts = expert_counts(flat_e, n_experts)[:n_experts]
    starts = torch.cumsum(counts, 0) - counts                  # exclusive
    rank = (torch.arange(s * k, device=dev)
            - starts[torch.clamp(e_sorted, max=n_experts - 1)])
    eff = capacity if cap_row is None else cap_row
    keep = (rank < eff) & (e_sorted < n_experts)
    dest = torch.where(keep, e_sorted * capacity + rank,
                       torch.full_like(rank, n_experts * capacity))
    src = x[t_sorted] * keep[:, None].to(x.dtype)
    buf = torch.zeros((n_experts * capacity + 1, x.shape[-1]), dtype=x.dtype,
                      device=dev)
    buf.index_add_(0, dest, src)       # row E*C takes the dropped slots
    w_keep = torch.where(keep, w_sorted, torch.zeros_like(w_sorted))
    return buf[:-1], dest, t_sorted, w_keep


def _combine_row(y_exp: torch.Tensor, dest: torch.Tensor,
                 t_sorted: torch.Tensor, w_keep: torch.Tensor,
                 seq: int) -> torch.Tensor:
    """Scatter expert outputs back to token order with routing weights (a
    dropped slot reads a zero row and carries weight 0)."""
    padded = torch.cat([y_exp, y_exp.new_zeros((1, y_exp.shape[-1]))])
    gathered = padded[dest] * w_keep[:, None].to(y_exp.dtype)
    out = y_exp.new_zeros((seq, y_exp.shape[-1]))
    return out.index_add_(0, t_sorted, gathered)


def _rank_within_expert(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """ids (..., S, k) -> rank (..., S, k): each (token, slot)'s position in
    its expert's arrival order, row-major over (S, k).  A sentinel id
    (>= n_experts) advances no counter; its rank is meaningless."""
    shape = ids.shape
    flat = ids.reshape(shape[:-2] + (-1,))                     # (..., S*k)
    oh = (flat[..., None] == torch.arange(n_experts, device=ids.device)
          ).to(torch.int32)                                    # (..., S*k, E)
    rank_flat = torch.cumsum(oh, dim=-2) - oh                  # exclusive
    rank = torch.gather(rank_flat, -1,
                        torch.clamp(flat, max=n_experts - 1)[..., None])
    return rank[..., 0].reshape(shape)


def _expert_ffn(params, cfg: LMConfig, disp: torch.Tensor) -> torch.Tensor:
    """disp (B, E, C, d) -> (B, E, C, d) through each expert's SwiGLU, as
    batched matmuls over E (each expert's weights read once)."""
    cd = cfg.cdtype()
    b, e, c, d = disp.shape
    xe = disp.permute(1, 0, 2, 3).reshape(e, b * c, d)
    act = activation(cfg.act)
    h = act(torch.matmul(xe, params["wg"].to(cd))) \
        * torch.matmul(xe, params["wi"].to(cd))
    y = torch.matmul(h, params["wo"].to(cd))                   # (E, B*C, d)
    return y.reshape(e, b, c, d).permute(1, 0, 2, 3)


def _moe_onehot(params, cfg: LMConfig, x, logits, cap: int,
                token_mask: Optional[torch.Tensor] = None,
                cap_rows: Optional[torch.Tensor] = None):
    """GShard dispatch and combine as einsums over one-hot tensors.  The
    routing weight is folded into the expert one-hot before the combine
    einsum: each (s, e, c) has at most one non-zero term over k, so the
    values are the three-operand einsum's without its (B, S, k, E, C)
    intermediate."""
    m = cfg.moe
    cd = cfg.cdtype()
    dev = x.device
    vals, ids = top_k(logits, m.top_k)                         # (B, S, k)
    w = torch.softmax(vals, dim=-1).to(cd)
    if token_mask is not None:
        # sentinel expert id E: an all-zero one-hot row, so masked tokens
        # neither dispatch nor advance any expert's rank counter
        ids = torch.where(token_mask[:, :, None], ids,
                          torch.full_like(ids, m.n_experts))
    rank = _rank_within_expert(ids, m.n_experts)
    eff = cap if cap_rows is None else cap_rows[:, None, None]
    keep = rank < eff
    if token_mask is not None:
        keep = keep & token_mask[:, :, None]
    oh_e = (ids[..., None] == torch.arange(m.n_experts, device=dev)
            ).to(cd)                                           # (B,S,k,E)
    slot = torch.where(keep, rank, torch.full_like(rank, cap))
    oh_c = (slot[..., None] == torch.arange(cap, device=dev)
            ).to(cd)                                           # (B,S,k,C)
    disp_w = torch.einsum("bske,bskc->becs", oh_e, oh_c)
    comb_w = torch.einsum("bske,bskc->becs",
                          oh_e * (w * keep.to(cd))[..., None], oh_c)
    disp = torch.einsum("becs,bsd->becd", disp_w, x.to(cd))
    y_e = _expert_ffn(params, cfg, disp)
    return torch.einsum("becs,becd->bsd", comb_w, y_e)


def _moe_scatter(params, cfg: LMConfig, x, logits, cap: int,
                 token_mask: Optional[torch.Tensor] = None,
                 cap_rows: Optional[torch.Tensor] = None):
    """Per-row sort / scatter dispatch (a Python loop over batch rows)."""
    m = cfg.moe
    cd = cfg.cdtype()
    b, s, d = x.shape
    rows = []
    for i in range(b):
        w, ids = _route_row(logits[i], m.top_k)
        dispatched, dest, t_sorted, w_keep = _dispatch_row(
            x[i].to(cd), ids, w.to(cd), m.n_experts, cap,
            mask=None if token_mask is None else token_mask[i],
            cap_row=None if cap_rows is None else cap_rows[i])
        y_e = _expert_ffn(params, cfg,
                          dispatched.reshape(1, m.n_experts, cap, d))[0]
        rows.append(_combine_row(y_e.reshape(m.n_experts * cap, d), dest,
                                 t_sorted, w_keep, s))
    return torch.stack(rows)


def moe_apply(params: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
              token_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux loss).

    ``token_mask`` (B, S) marks real tokens of a right-padded ragged batch:
    masked tokens neither route, consume capacity nor enter the aux loss,
    and each row's effective capacity derives from its real token count.
    The router reads ``router`` / ``router_b`` in float32, as they are
    kept (``lm.compute_params`` leaves them in the parameter type)."""
    m = cfg.moe
    b, s, d = x.shape

    # decode (S == 1) routes the batch's tokens as one row, so the
    # capacity floor applies once, not per row
    flattened = s == 1 and b > 1 and m.global_decode_dispatch
    if flattened:
        x = x.reshape(1, b, d)
        b, s = 1, b
        if token_mask is not None:
            token_mask = token_mask.reshape(1, s)

    cap = _capacity(s, m)
    cap_rows = None
    if token_mask is not None:
        token_mask = token_mask.to(torch.bool)
        # real count <= S means row cap <= buffer cap: the minimum is a
        # safety net, not a change of behaviour
        cap_rows = torch.clamp(_capacity_dyn(token_mask.sum(1), m), max=cap)
    logits = x.float() @ params["router"].float()
    if "router_b" in params:
        logits = logits + params["router_b"].float()

    if m.dispatch == "onehot":
        y = _moe_onehot(params, cfg, x, logits, cap, token_mask, cap_rows)
    elif m.dispatch == "scatter":
        y = _moe_scatter(params, cfg, x, logits, cap, token_mask, cap_rows)
    else:
        raise ValueError(f"moe dispatch must be onehot or scatter, got "
                         f"{m.dispatch!r}")

    # Switch-style load-balance auxiliary loss: E * sum(f_e * p_e)
    probs = torch.softmax(logits, dim=-1)                      # (B, S, E)
    _, top_ids = top_k(logits, m.top_k)
    oh_top = (top_ids[..., None] == torch.arange(m.n_experts,
                                                 device=x.device)).float()
    if token_mask is None:
        frac = oh_top.mean(dim=(0, 1, 2))
        pmean = probs.mean(dim=(0, 1))
    else:                              # means over real tokens only
        mw = token_mask.float()
        denom = torch.clamp(mw.sum(), min=1.0)
        frac = (oh_top * mw[:, :, None, None]).sum(dim=(0, 1, 2)) \
            / (denom * m.top_k)
        pmean = (probs * mw[:, :, None]).sum(dim=(0, 1)) / denom
    aux = m.n_experts * (frac * pmean).sum()

    if m.n_shared:
        y = y + mlp_lib.mlp_apply(params["shared"], cfg, x)
    if flattened:
        y = y.reshape(-1, 1, d)               # (1, B, d) -> (B, 1, d)
    return y.to(x.dtype), aux

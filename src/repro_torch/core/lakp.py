"""Look-Ahead Kernel Pruning (LAKP) — the paper's Algorithm 1 — plus baselines.

Paper semantics
---------------
Eq. 1 (per-parameter look-ahead score, from Park et al. ICLR'20):

    L_i(w) = |w| * ||W_{i-1}[j, :]||_F * ||W_{i+1}[:, k]||_F

Algorithm 1 (kernel-structured): the score of a *kernel* — one (out_ch,
in_ch) k x k slice of a conv weight — is the SUM of the look-ahead scores of
its parameters.  Per layer, the lowest-scored kernels are masked until the
layer's sparsity target is met.

Fig. 7 works the example with L1 kernel norms (sums of |w|), not Frobenius:

    score(W_i(a,b)) = sum|W_i(a,b)|
                      * (sum_c sum|W_{i-1}(b,c)|)      # kernels producing in-ch b
                      * (sum_d sum|W_{i+1}(d,a)|)      # kernels consuming out-ch a

    giving 2295 / 2280 / 3060 / 3800 for the 2x2x3x3 example and, at 50%
    sparsity, mask [[0,0],[1,1]].

We implement both norms (``norm="l1"`` matches Fig. 7 and is the default;
``norm="fro"`` matches Eq. 1 verbatim).  Boundary layers use 1.0 for the
missing neighbour factor (Park et al. convention).

Weight layout: conv kernels are OIHW — shape (out_ch, in_ch, kh, kw).  A
"kernel" is one [o, i, :, :] slice.  Dense layers participate as neighbours
with shape (in, out) (one "kernel" per (in, out) scalar — the general case of
kh = kw = 1).

Baselines implemented alongside (the paper compares against both):
  * ``kp_scores``           — magnitude-based Kernel Pruning [14] (Mao et al.)
  * ``unstructured_mask``   — per-weight magnitude pruning [21] (Han et al.)

Generalization to LM structures: ``block_lookahead_scores`` scores any
structured block (FFN hidden unit, attention head, MoE expert) as
n(W_in block) * n(W_out block), the look-ahead product restricted to the
structure's own fan-in and fan-out matrices; ``prune_blocks`` masks the
lowest-scored blocks and ``compact_blocks`` removes them.

This is the PyTorch counterpart of ``repro.core.lakp``.  Masks must equal
the reference's bit for bit, so every ranking is a *stable* argsort (ties go
to the lower index, in both packages) and the index vectors are ascending
``nonzero`` results.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# Norm helpers
# ---------------------------------------------------------------------------


def _kernel_norms(w: torch.Tensor, norm: str) -> torch.Tensor:
    """Per-kernel norms of an OIHW conv weight -> (out_ch, in_ch).

    Also accepts 2-D (in, out) dense weights, returning |w| (or w^2 for
    ``fro`` — see note below) transposed to (out, in).
    """
    if w.ndim == 2:  # dense (in, out) -> treat each scalar as a 1x1 kernel
        a = w.abs().T if norm == "l1" else w.square().T
        return a
    assert w.ndim == 4, f"expected OIHW conv weight, got shape {w.shape}"
    if norm == "l1":
        return w.abs().sum(dim=(2, 3))
    # For Frobenius the *sums over kernels* below must add squares and take
    # the root at the end, so return squared sums here.
    return w.square().sum(dim=(2, 3))


def _finalize(x: torch.Tensor, norm: str) -> torch.Tensor:
    return x if norm == "l1" else torch.sqrt(x)


# ---------------------------------------------------------------------------
# LAKP kernel scores (Algorithm 1 lines 5-7)
# ---------------------------------------------------------------------------


def lakp_kernel_scores(
    w_i: torch.Tensor,
    w_prev: Optional[torch.Tensor] = None,
    w_next: Optional[torch.Tensor] = None,
    norm: str = "l1",
) -> torch.Tensor:
    """Look-ahead scores for every kernel of layer i -> (out_ch, in_ch).

    ``w_prev``/``w_next`` are the adjacent layers' weights (OIHW conv or
    (in, out) dense); ``None`` means the layer is at a boundary and the
    corresponding factor is 1.
    """
    own = _kernel_norms(w_i, norm)                        # (O, I)
    o, i = own.shape

    if w_prev is not None:
        prev = _kernel_norms(w_prev, norm)                # (O_prev=I, I_prev)
        assert prev.shape[0] == i, (
            f"prev layer out_ch {prev.shape[0]} != layer in_ch {i}")
        prev_fac = prev.sum(dim=1)                       # (I,)
    else:
        prev_fac = torch.ones((i,), dtype=w_i.dtype, device=w_i.device)

    if w_next is not None:
        nxt = _kernel_norms(w_next, norm)                 # (O_next, I_next=O)
        assert nxt.shape[1] == o, (
            f"next layer in_ch {nxt.shape[1]} != layer out_ch {o}")
        next_fac = nxt.sum(dim=0)                        # (O,)
    else:
        next_fac = torch.ones((o,), dtype=w_i.dtype, device=w_i.device)

    own = _finalize(own, norm)
    prev_fac = _finalize(prev_fac, norm)
    next_fac = _finalize(next_fac, norm)
    return own * prev_fac[None, :] * next_fac[:, None]


def kp_scores(w_i: torch.Tensor) -> torch.Tensor:
    """Magnitude-based kernel pruning [14]: score = sum |w| per kernel."""
    return _kernel_norms(w_i, "l1")


# ---------------------------------------------------------------------------
# Masking (Algorithm 1 lines 8-10)
# ---------------------------------------------------------------------------


def mask_from_scores(scores: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero the ``sparsity`` fraction of lowest-scored entries.

    Exactly floor(sparsity * N) entries are pruned (deterministic count, as
    Algorithm 1's s_i-th smallest threshold implies).  Ties are broken by
    flat index (stable), making the mask deterministic.
    """
    flat = scores.reshape(-1)
    n = flat.shape[0]
    n_prune = int(sparsity * n)
    if n_prune <= 0:
        return torch.ones_like(flat, dtype=torch.float32).reshape(scores.shape)
    if n_prune >= n:
        return torch.zeros_like(flat, dtype=torch.float32).reshape(scores.shape)
    # argsort ascending; prune the first n_prune positions.
    order = torch.argsort(flat, stable=True)
    mask = torch.ones((n,), dtype=torch.float32, device=scores.device)
    mask[order[:n_prune]] = 0.0
    return mask.reshape(scores.shape)


def apply_kernel_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 line 10: W~ = M . W  (mask broadcast over kernel dims)."""
    if w.ndim == 4:
        return w * mask[:, :, None, None].to(w.dtype)
    if w.ndim == 2:
        return w * mask.T.to(w.dtype)
    raise ValueError(f"unsupported weight ndim {w.ndim}")


# ---------------------------------------------------------------------------
# Algorithm 1 — whole-network layer-wise LAKP
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PruneResult:
    weights: List[torch.Tensor]      # pruned (masked) weights, same shapes
    masks: List[torch.Tensor]        # (out_ch, in_ch) kernel masks per layer
    scores: List[torch.Tensor]       # kernel scores per layer


def lakp_prune(
    weights: Sequence[torch.Tensor],
    sparsities: Sequence[float],
    norm: str = "l1",
) -> PruneResult:
    """Algorithm 1: layer-wise look-ahead kernel pruning of a conv chain.

    ``weights`` — the L conv weights (OIHW), in forward order.  Layer i's
    neighbours are weights[i-1] and weights[i+1] (boundary -> factor 1).
    ``sparsities`` — desired per-layer kernel sparsity s_i in [0, 1).
    """
    assert len(weights) == len(sparsities)
    out_w, out_m, out_s = [], [], []
    for i, w in enumerate(weights):
        w_prev = weights[i - 1] if i > 0 else None
        w_next = weights[i + 1] if i + 1 < len(weights) else None
        scores = lakp_kernel_scores(w, w_prev, w_next, norm=norm)
        mask = mask_from_scores(scores, float(sparsities[i]))
        out_w.append(apply_kernel_mask(w, mask))
        out_m.append(mask)
        out_s.append(scores)
    return PruneResult(out_w, out_m, out_s)


def kp_prune(
    weights: Sequence[torch.Tensor],
    sparsities: Sequence[float],
) -> PruneResult:
    """Magnitude-based kernel pruning [14] with the same masking machinery."""
    out_w, out_m, out_s = [], [], []
    for w, s in zip(weights, sparsities):
        scores = kp_scores(w)
        mask = mask_from_scores(scores, float(s))
        out_w.append(apply_kernel_mask(w, mask))
        out_m.append(mask)
        out_s.append(scores)
    return PruneResult(out_w, out_m, out_s)


def unstructured_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Per-weight magnitude pruning [21]: mask of w's shape."""
    return mask_from_scores(w.abs(), sparsity)


# ---------------------------------------------------------------------------
# Structured-pruning bookkeeping (paper §III-C)
# ---------------------------------------------------------------------------


def surviving_channel_index(mask: torch.Tensor, group: int = 1) -> torch.Tensor:
    """Output channels (groups of ``group`` channels) with >=1 surviving kernel.

    This is the paper's "index memory": with structured kernel pruning only
    per-kernel (or per-channel-group) indices are stored — 0.1% of surviving
    weights rather than per-weight indices as in unstructured pruning.
    ``group`` > 1 groups output channels (a PrimaryCaps capsule type spans
    ``caps_dim`` conv output channels).
    """
    alive = (mask > 0).any(dim=1)                         # (O,) any in-ch alive
    if group > 1:
        o = alive.shape[0]
        alive = alive.reshape(o // group, group).any(dim=1)
    return torch.nonzero(alive)[:, 0]


def index_overhead_bytes(masks: Sequence[torch.Tensor], bytes_per_index: int = 2
                         ) -> int:
    """Bytes needed to store surviving-kernel indices (paper: ~0.1%)."""
    total = 0
    for m in masks:
        total += int((m > 0).sum()) * bytes_per_index
    return total


def effective_compression(masks: Sequence[torch.Tensor],
                          weights: Sequence[torch.Tensor]) -> float:
    """Fraction of conv parameters removed (the paper's compression rate)."""
    kept = 0
    total = 0
    for m, w in zip(masks, weights):
        kernel_size = int(w.shape[2] * w.shape[3]) if w.ndim == 4 else 1
        kept += int((m > 0).sum()) * kernel_size
        total += int(w.numel())
    return 1.0 - kept / max(total, 1)


# ---------------------------------------------------------------------------
# Generalization to LM structures: FFN units, heads, experts
# ---------------------------------------------------------------------------


def _block_sums(w_in: torch.Tensor, w_out: torch.Tensor, n_blocks: int,
                fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(w)`` summed over each block's columns of ``w_in`` (d, f) and rows
    of ``w_out`` (f, d): two (n_blocks,) vectors."""
    d, f = w_in.shape
    if w_out.shape[0] != f or f % n_blocks:
        raise ValueError(f"blocks: w_in {tuple(w_in.shape)}, w_out "
                         f"{tuple(w_out.shape)}, {n_blocks} blocks")
    blk = f // n_blocks
    a = fn(w_in).reshape(d, n_blocks, blk).sum(dim=(0, 2))
    b = fn(w_out).reshape(n_blocks, blk, -1).sum(dim=(1, 2))
    return a, b


def block_lookahead_scores(w_in: torch.Tensor, w_out: torch.Tensor,
                           n_blocks: int, norm: str = "l1") -> torch.Tensor:
    """Look-ahead scores of ``n_blocks`` structured blocks of a paired
    (W_in: (d, f), W_out: (f, d)) layer — FFN hidden units grouped into
    blocks, attention heads (f = n_heads * head_dim), MoE experts.

    score(block) = n(W_in[:, block]) * n(W_out[block, :])"""
    if norm == "l1":
        a, b = _block_sums(w_in, w_out, n_blocks, torch.abs)
    else:
        a, b = _block_sums(w_in, w_out, n_blocks, torch.square)
        a, b = torch.sqrt(a), torch.sqrt(b)
    return a * b


def block_magnitude_scores(w_in: torch.Tensor, w_out: torch.Tensor,
                           n_blocks: int) -> torch.Tensor:
    """Magnitude (KP-style) block scores: n1(W_in block) + n1(W_out block)."""
    a, b = _block_sums(w_in, w_out, n_blocks, torch.abs)
    return a + b


def prune_blocks(w_in: torch.Tensor, w_out: torch.Tensor, n_blocks: int,
                 sparsity: float, method: str = "lakp", norm: str = "l1"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask whole blocks of a paired FFN-like layer; returns (w_in~, w_out~,
    block mask (n_blocks,))."""
    if method == "lakp":
        scores = block_lookahead_scores(w_in, w_out, n_blocks, norm)
    elif method == "kp":
        scores = block_magnitude_scores(w_in, w_out, n_blocks)
    else:
        raise ValueError(f"method must be lakp or kp, got {method!r}")
    mask = mask_from_scores(scores, sparsity)             # (n_blocks,)
    m_f = torch.repeat_interleave(mask, w_in.shape[1] // n_blocks)   # (f,)
    return (w_in * m_f[None, :].to(w_in.dtype),
            w_out * m_f[:, None].to(w_out.dtype), mask)


def compact_blocks(w_in: torch.Tensor, w_out: torch.Tensor,
                   mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Physically remove pruned blocks (compaction, not sparse indexing).
    Returns the compacted (w_in, w_out) and the surviving block indices."""
    idx = torch.nonzero(mask > 0)[:, 0]
    n_blocks = mask.shape[0]
    d, f = w_in.shape
    blk = f // n_blocks
    w_in_b = w_in.reshape(d, n_blocks, blk)[:, idx].reshape(d, -1)
    w_out_b = w_out.reshape(n_blocks, blk, -1)[idx].reshape(
        -1, w_out.shape[1])
    return w_in_b, w_out_b, idx

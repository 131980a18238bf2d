"""Counter-based fused sampling: the math, shared by the plain version and
the host path.

A request's token at sequence position ``pos`` is a pure function of
``(request seed, position, logits)``: the randomness is a counter hash of
``(seed, pos, vocab lane)`` and the draw is a Gumbel-argmax over the kept
lanes, so no generator state travels with a request (preemption, slot
order and batch composition cannot change a draw):

    h    = seed ^ (pos * 0x9E3779B9) ^ (lane * 0x85EBCA6B)   (uint32)
    h    = fmix32(h)                    # murmur3 finalizer
    u    = (h >> 8) * 2^-24, clamped >= 1e-7
    tok  = argmax_{kept lanes}( logits/T + (-log(-log u)) )

Top-k / top-p restrict the kept lanes through 30-step bisections over the
scaled-logit range.  The argmax lane is always kept, and greedy
(``temperature <= 0``) is an exact argmax of the raw logits.

:func:`sample_tokens` is the whole-batch version in PyTorch (the plain
version of the ``fused_sampling`` kernel and its oracle).  PyTorch has no
general uint32 arithmetic, so the hash runs in int64 masked to 32 bits,
with each 32 x 32-bit product split so that it never leaves int64.
:func:`sample_token_host` is the numpy version of one row, used by the
engine's host sampling path; libm and PyTorch transcendentals may differ in
the last ulp, so the two paths are only promised to agree on greedy rows.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
_GOLD = 0x9E3779B9        # 2^32 / golden ratio: position stride
_MIX1 = 0x85EBCA6B        # murmur3 fmix32 constants
_MIX2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF
_BISECT_STEPS = 30        # halves the float32 value range to ~1e-9


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): the low and high 16
    bits of ``a`` are multiplied apart so that no product passes 2^48."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _uniform_lanes(seeds: torch.Tensor, pos: torch.Tensor, v: int
                   ) -> torch.Tensor:
    """(b, v) uniforms in (0, 1), a pure function of (seed, pos, lane)."""
    dev = seeds.device
    lane = torch.arange(v, dtype=torch.int64, device=dev)[None, :]
    s = seeds.to(torch.int64)[:, None] & _MASK
    p = _mul32(pos.to(torch.int64)[:, None] & _MASK, _GOLD)
    h = s ^ p ^ _mul32(lane, _MIX1)
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    h = h ^ (h >> 16)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, min=1e-7)


def _topk_lo(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(b,) the largest lo found with count(z >= lo) >= k, by bisection
    over [min z, max z]; ``k <= 0`` means k = V."""
    b, v = z.shape
    k_eff = torch.clamp(torch.where(k <= 0, v, k), 1, v)
    lo = z.amin(dim=-1)
    hi = z.amax(dim=-1)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        ge = (z >= mid[:, None]).sum(dim=-1) >= k_eff
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    return lo


def _topk_mask(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep lanes >= the k-th largest value of each row (ties kept);
    ``k <= 0`` means no restriction.  Invariant: count(z >= lo) >= k."""
    return z >= _topk_lo(z, k)[:, None]


def _probs(z: torch.Tensor) -> torch.Tensor:
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _topp_lo(z: torch.Tensor, p: torch.Tensor,
             probs: torch.Tensor) -> torch.Tensor:
    """(b,) the largest lo found with sum(probs[z > lo]) >= p, by
    bisection over [min z - 1, max z]."""
    lo = z.amin(dim=-1) - 1.0
    hi = z.amax(dim=-1)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        c = torch.where(z > mid[:, None], probs, 0.0).sum(dim=-1)
        ge = c >= p
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    return lo


def _topp_mask(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Keep the smallest prefix of probability mass >= p (nucleus);
    ``p >= 1`` keeps everything.  Invariant: sum(prob[z > lo]) >= p."""
    lo = _topp_lo(z, p, _probs(z))
    return (z > lo[:, None]) | (p >= 1.0)[:, None]


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  seeds: torch.Tensor, pos: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """logits (B, V); per-row temperature / seeds / pos / top_k / top_p
    (B,) -> (B,) int32 tokens."""
    x = logits.float()
    b, v = x.shape
    temperature = temperature.float().reshape(b)
    top_p = top_p.float().reshape(b)
    greedy = torch.argmax(x, dim=-1)
    u = _uniform_lanes(seeds.reshape(b), pos.reshape(b), v)
    gumbel = -torch.log(-torch.log(u))
    z = x / torch.clamp(temperature, min=1e-6)[:, None]
    keep = _topk_mask(z, top_k.reshape(b).to(torch.int64)) \
        & _topp_mask(z, top_p)
    lane = torch.arange(v, device=x.device)[None, :]
    keep = keep | (lane == greedy[:, None])
    sampled = torch.argmax(torch.where(keep, z + gumbel, NEG_INF), dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def fused_sampling_ref(logits, temperature, seeds, pos, top_k, top_p):
    """Oracle of the fused sampling kernel: :func:`sample_tokens`."""
    return sample_tokens(logits, temperature, seeds, pos, top_k, top_p)


def sample_token_host(logits_row, temperature, seed, pos,
                      top_k: int = 0, top_p: float = 1.0) -> int:
    """numpy version of :func:`sample_tokens` for one row (the host
    sampling path).  Greedy is the same argmax; temperature > 0 follows the
    same algorithm (hash, bisections, Gumbel-argmax)."""
    x = np.asarray(logits_row, np.float32)
    if temperature <= 0.0:
        return int(np.argmax(x))
    v = x.shape[0]
    base = (int(seed) ^ ((int(pos) * _GOLD) & _MASK)) & _MASK
    lane = np.arange(v, dtype=np.uint32)
    h = np.uint32(base) ^ (lane * np.uint32(_MIX1))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_MIX1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_MIX2)
    h = h ^ (h >> np.uint32(16))
    u = (h >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    u = np.maximum(u, np.float32(1e-7))
    gumbel = -np.log(-np.log(u))
    z = x / np.float32(max(float(temperature), 1e-6))
    k_eff = v if top_k <= 0 else min(max(int(top_k), 1), v)
    lo, hi = np.float32(z.min()), np.float32(z.max())
    for _ in range(_BISECT_STEPS):
        mid = np.float32(0.5) * (lo + hi)
        if int(np.sum(z >= mid)) >= k_eff:
            lo = mid
        else:
            hi = mid
    keep = z >= lo
    if top_p < 1.0:
        e = np.exp(z - z.max())
        probs = e / e.sum()
        lo, hi = np.float32(z.min() - 1.0), np.float32(z.max())
        for _ in range(_BISECT_STEPS):
            mid = np.float32(0.5) * (lo + hi)
            if float(probs[z > mid].sum()) >= top_p:
                lo = mid
            else:
                hi = mid
        keep &= z > lo
    keep[int(np.argmax(x))] = True
    return int(np.argmax(np.where(keep, z + gumbel, np.float32(NEG_INF))))

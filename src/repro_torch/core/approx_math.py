"""FastCaps approximate math (paper §III-B) in PyTorch.

Eq. 2 — Taylor expansion of exp around a = 0.5, 5 multiply + 5 add (Horner):

    e^x ≈ e^a · (0.60653 + x·(0.60659 + x·(0.30260 + x·(0.10347 +
                 x·(0.02118 + 0.00833·x)))))

The polynomial is pure multiply-add work.  It is kept as a *faithful mode*
of the routing softmax; the CUDA kernels hold the same constants and the
same order of operations in ``csrc/approx_math.cuh``, and these functions
are what they are checked against.

Beyond-paper extension: the raw polynomial is only accurate on roughly
x ∈ [-1.5, 2.5].  CapsNet routing logits live there; attention logits do not.
``range_reduce=True`` applies exp(x) = exp(x/2^k)^(2^k) with fixed k=5 (five
squarings — still multiply-only), extending usable range to ~[-48, 48].

Eq. 3 — a/b = exp(log a − log b), the paper's fixed-point divider
replacement; implemented for fidelity, off by default.
"""

from __future__ import annotations

import torch

# Paper Eq. 2 constants (a = 0.5).
TAYLOR_A = 0.5
E_A = 1.6487212707001282  # e^0.5
TAYLOR_COEFFS = (0.60653, 0.60659, 0.30260, 0.10347, 0.02118, 0.00833)


def taylor_exp_raw(x: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 2 verbatim: 5 multiplies + 5 adds (Horner) + 1 scale."""
    c0, c1, c2, c3, c4, c5 = TAYLOR_COEFFS
    p = c4 + c5 * x
    p = c3 + x * p
    p = c2 + x * p
    p = c1 + x * p
    p = c0 + x * p
    return E_A * p


def taylor_exp(x: torch.Tensor, range_reduce: bool = False,
               reduce_k: int = 5) -> torch.Tensor:
    """Eq. 2 exp; optionally with square-and-multiply range reduction."""
    if not range_reduce:
        return taylor_exp_raw(x)
    scale = float(2 ** reduce_k)
    # Clamp so exp(x) for very negative x flushes to ~0 without the polynomial
    # going negative (poly has roots below ~ -1.6 after scaling).
    x = torch.clamp(x, -scale, scale)
    y = taylor_exp_raw(x / scale)
    for _ in range(reduce_k):
        y = y * y
    return y


def div_exp_log(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-30
                ) -> torch.Tensor:
    """Paper Eq. 3: a/b = exp(log a − log b), for a,b > 0."""
    return torch.exp(torch.log(torch.clamp(a, min=eps))
                     - torch.log(torch.clamp(b, min=eps)))


def taylor_softmax(x: torch.Tensor, axis: int = -1,
                   range_reduce: bool = True,
                   use_div_exp_log: bool = False) -> torch.Tensor:
    """Softmax using Eq. 2 exp (and optionally Eq. 3 division)."""
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    e = taylor_exp(x - m, range_reduce=range_reduce)
    denom = torch.sum(e, dim=axis, keepdim=True)
    if use_div_exp_log:
        return div_exp_log(e, denom)
    return e / torch.clamp(denom, min=1e-30)


def squash(s: torch.Tensor, axis: int = -1, eps: float = 1e-9
           ) -> torch.Tensor:
    """CapsNet squash: v = (‖s‖²/(1+‖s‖²)) · s/‖s‖ (Sabour et al. Eq. 1)."""
    sq = torch.sum(torch.square(s), dim=axis, keepdim=True)
    norm = torch.sqrt(sq + eps)
    return (sq / (1.0 + sq)) * (s / norm)


def squash_fast(s: torch.Tensor, axis: int = -1, eps: float = 1e-9
                ) -> torch.Tensor:
    """Squash with a single rsqrt (the form the routing kernel uses; the
    paper's Fig. 11a computes ‖s‖² once)."""
    sq = torch.sum(torch.square(s), dim=axis, keepdim=True)
    inv = torch.rsqrt(sq + eps)
    return s * (sq * inv / (1.0 + sq))

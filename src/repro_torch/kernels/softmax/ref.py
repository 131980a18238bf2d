"""Plain PyTorch versions of the Taylor-softmax kernels: the Eq. 2 softmax
over the last axis, and its backward."""

from __future__ import annotations

import torch

from repro_torch.core import approx_math


def taylor_softmax_ref(x: torch.Tensor, range_reduce: bool = True,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The Eq. 2 softmax over the last axis, evaluated in ``dtype`` (float32
    as the kernel; float64 gives an oracle of the same formula, which
    measures float32's own rounding), in ``x``'s type."""
    xf = x.to(dtype)
    m = torch.amax(xf, dim=-1, keepdim=True)
    e = approx_math.taylor_exp(xf - m, range_reduce=range_reduce)
    return (e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
            ).to(x.dtype)


def taylor_softmax_bwd_ref(x: torch.Tensor, g: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The gradient of ``taylor_softmax_ref(x)`` against the output
    cotangent ``g``, as ``jax.grad`` takes it through the reference's
    ``taylor_softmax`` (``repro/core/approx_math.py:65``), in ``x``'s type:

        dx_j = e'(x_j - m) * (g_j - sum_i g_i o_i) / S

    with ``m = max(x)`` held constant, ``S = sum(e)``, ``o = e / S`` and
    ``e'(z) = p^31 * E_A * poly'(t)``, ``t = clip(z, -32, 32) / 32``, times
    the clip's derivative: 1 inside, 1/2 exactly on the edge (``jax.grad``
    of ``jnp.clip`` splits a tie; autograd of ``torch.clamp`` would give 1)
    and 0 outside.  ``S >= p(0)^32`` (about 1), so ``max(S, 1e-30)`` is S.
    Evaluated in ``dtype``, as :func:`taylor_softmax_ref`."""
    xf = x.to(dtype)
    gf = g.to(dtype)
    scale = 32.0
    z = xf - torch.amax(xf, dim=-1, keepdim=True)
    t = torch.clamp(z, -scale, scale) / scale
    p = approx_math.taylor_exp_raw(t)
    p2 = p * p
    p4 = p2 * p2
    p8 = p4 * p4
    p16 = p8 * p8
    e = p16 * p16
    c = approx_math.TAYLOR_COEFFS
    dp = 4.0 * c[4] + 5.0 * c[5] * t
    dp = 3.0 * c[3] + t * dp
    dp = 2.0 * c[2] + t * dp
    dp = c[1] + t * dp
    edge = (z == -scale) | (z == scale)
    clip = torch.where(edge, 0.5, ((z > -scale) & (z < scale)).to(xf.dtype))
    de = p16 * p8 * p4 * p2 * p * approx_math.E_A * dp * clip
    s = torch.sum(e, dim=-1, keepdim=True)
    dot = torch.sum(gf * e, dim=-1, keepdim=True) / s
    return (de * (gf - dot) / s).to(x.dtype)

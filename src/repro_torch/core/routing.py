"""Dynamic routing between capsules (Sabour et al., paper Fig. 4).

Inputs: prediction vectors ``u_hat`` of shape (B, N_in, N_out, D_out) where
``u_hat[b, i, j, :]`` is capsule i's prediction for parent capsule j.

Algorithm (r iterations, r=3 in the paper):

    b_ij = 0
    repeat r times:
        c_i: = softmax(b_i:)                 over parents j     (Softmax step)
        s_j  = sum_i c_ij * u_hat_ij                            (FC step)
        v_j  = squash(s_j)                                      (Squash step)
        b_ij += <u_hat_ij, v_j>                                 (Agreement step)

Variant selection lives in ``repro_torch.deploy``: build a typed
``RoutingSpec`` and ``resolve()`` it through the registry; the free
functions below are the registered implementations.

Variants (``mode``):
  * ``reference``  — exact softmax/div, einsum contractions, ``squash``, the
        agreement step on every iteration; the oracle.
  * ``optimized``  — the FastCaps §III-B simplifications, one operation
        per step: Taylor-series exp (Eq. 2) in the softmax (the
        ``taylor_softmax`` kernel on the card), optional exp/log division
        (Eq. 3), ``squash_fast``.
  * ``cuda``       — kernels/routing: the whole r-iteration loop fused in
        one hand-written kernel with ``b``, ``c``, ``v`` resident in shared
        memory (the paper's "everything in BRAM").

All variants return (v, c_last): parent capsules (B, N_out, D_out) and the
final coupling coefficients (B, N_in, N_out).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import approx_math


def _softmax_parents(b: torch.Tensor, mode: str,
                     use_div_exp_log: bool = False) -> torch.Tensor:
    """Softmax over the parent axis (last axis of (B, N_in, N_out)).

    The Eq. 2 softmax goes through the ``taylor_softmax`` kernel's wrapper
    (the kernel on the card, its plain version on the host); the Eq. 3
    division is not part of that kernel and stays plain PyTorch."""
    if mode == "taylor":
        if use_div_exp_log:
            return approx_math.taylor_softmax(
                b, axis=-1, range_reduce=True, use_div_exp_log=True)
        from repro_torch import kernels

        return kernels.taylor_softmax(b)
    return torch.softmax(b, dim=-1)


def route_reference(u_hat: torch.Tensor, n_iters: int = 3,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle implementation — direct transcription of Fig. 4."""
    bsz, n_in, n_out, _ = u_hat.shape
    uf = u_hat.to(torch.float32)
    b = torch.zeros((bsz, n_in, n_out), dtype=torch.float32,
                    device=u_hat.device)
    c = v = None
    for _ in range(n_iters):
        c = torch.softmax(b, dim=-1)                         # (B, I, J)
        s = torch.einsum("bij,bijd->bjd", c, uf)             # FC
        v = approx_math.squash(s, axis=-1)                   # Squash
        b = b + torch.einsum("bijd,bjd->bij", uf, v)         # Agreement
    return v.to(u_hat.dtype), c


def route_optimized(u_hat: torch.Tensor, n_iters: int = 3,
                    softmax_mode: str = "taylor",
                    use_div_exp_log: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FastCaps-optimized routing (paper §III-B), unfused: Eq. 2 softmax,
    single-rsqrt squash, one contraction per step.  A variant of its own,
    not the fused kernel's fallback."""
    bsz, n_in, n_out, _ = u_hat.shape
    uf = u_hat.to(torch.float32)
    b = torch.zeros((bsz, n_in, n_out), dtype=torch.float32,
                    device=u_hat.device)
    c = v = None
    for _ in range(n_iters):
        c = _softmax_parents(b, softmax_mode, use_div_exp_log)
        s = torch.einsum("bij,bijd->bjd", c, uf)
        v = approx_math.squash_fast(s, axis=-1)
        b = b + torch.einsum("bijd,bjd->bij", uf, v)
    return v.to(u_hat.dtype), c


def route_cuda(u_hat: torch.Tensor, n_iters: int = 3,
               softmax_mode: str = "taylor",
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused routing kernel, dispatched through
    :data:`repro_torch.kernels.registry` (the launch geometry comes from the
    tuner cache or the deterministic defaults).  On a CPU tensor the
    kernel's wrapper runs its plain version."""
    from repro_torch import kernels

    return kernels.fused_routing(u_hat, n_iters=n_iters,
                                 softmax_mode=softmax_mode)


def routing_flops(bsz: int, n_in: int, n_out: int, d: int, n_iters: int = 3
                  ) -> int:
    """Analytic FLOP count of the routing loop (for Fig. 8 / roofline)."""
    per_iter = (
        2 * bsz * n_in * n_out * d      # FC (mul+add)
        + 2 * bsz * n_in * n_out * d    # Agreement
        + 6 * bsz * n_in * n_out        # softmax (exp + norm, ~6 flops/elt)
        + 6 * bsz * n_out * d           # squash
    )
    return per_iter * n_iters

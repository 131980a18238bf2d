"""Plain PyTorch version of the fused routing kernel (identical math, one
tensor operation per step)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import approx_math


def fused_routing_ref(u_hat: torch.Tensor, n_iters: int = 3,
                      softmax_mode: str = "exact"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_hat (B, I, J, D) -> (v (B, J, D), c (B, I, J)); fp32 internally.

    The agreement step is skipped on the last iteration (it changes neither
    ``v`` nor ``c``) and the squash is ``squash_fast``, as in the kernel."""
    u = u_hat.to(torch.float32)
    bsz, i_, j_, _ = u.shape
    b = torch.zeros((bsz, i_, j_), dtype=torch.float32, device=u.device)
    c = v = None
    for it in range(n_iters):
        if softmax_mode == "taylor":
            c = approx_math.taylor_softmax(b, axis=-1, range_reduce=True)
        else:
            c = torch.softmax(b, dim=-1)
        s = torch.einsum("bij,bijd->bjd", c, u)
        v = approx_math.squash_fast(s, axis=-1)
        if it < n_iters - 1:
            b = b + torch.einsum("bijd,bjd->bij", u, v)
    return v.to(u_hat.dtype), c

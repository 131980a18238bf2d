"""Plain PyTorch version of the Taylor-softmax kernel: Eq. 2 softmax over
the last axis."""

from __future__ import annotations

import torch

from repro_torch.core import approx_math


def taylor_softmax_ref(x: torch.Tensor, range_reduce: bool = True
                       ) -> torch.Tensor:
    xf = x.to(torch.float32)
    m = torch.amax(xf, dim=-1, keepdim=True)
    e = approx_math.taylor_exp(xf - m, range_reduce=range_reduce)
    return (e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
            ).to(x.dtype)

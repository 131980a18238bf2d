"""Wrapper of the fused sampling CUDA kernel (``csrc/sampling.cu``).

Replaces ``repro/kernels/sampling/kernel.py`` (``_fused_sampling_kernel`` /
``fused_sampling_pallas``): temperature, top-k, top-p and the counter-based
Gumbel draw of every row of a serving tick in one launch, so only the
(B,) int32 tokens leave the card.  One thread block serves one row; the
tunable is the block size.

:func:`fused_sampling_cuda` runs the plain version
(:func:`repro_torch.kernels.sampling.ref.sample_tokens`) only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises.
``fused_sampling_cuda.launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sampling.ref import sample_tokens

# per-row operands: name, dtype
_ROWS = (("temperature", torch.float32), ("seeds", torch.int32),
         ("pos", torch.int32), ("top_k", torch.int32),
         ("top_p", torch.float32))


def fused_sampling_cuda(logits: torch.Tensor, temperature: torch.Tensor,
                        seeds: torch.Tensor, pos: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        threads: int = 1024,
                        scratch: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """logits (B, V) float32; temperature, top_p (B,) float32; seeds, pos,
    top_k (B,) int32 -> (B,) int32 tokens.  ``scratch`` is the kernel's
    (B, 2, V) float32 work space (rows with temperature > 0 write their
    scaled logits and probabilities there); a caller that samples every
    tick passes one buffer it keeps, else one is allocated per call."""
    if logits.dim() != 2:
        raise ValueError(f"fused_sampling: logits must be (B, V), got "
                         f"{tuple(logits.shape)}")
    b, v = logits.shape
    rows = (temperature, seeds, pos, top_k, top_p)
    for (name, _), x in zip(_ROWS, rows):
        if tuple(x.shape) != (b,):
            raise ValueError(f"fused_sampling: {name} must be ({b},), got "
                             f"{tuple(x.shape)}")
        if x.device != logits.device:
            raise ValueError(f"fused_sampling: {name} on {x.device}, logits "
                             f"on {logits.device}")
    if logits.device.type == "cpu":
        return sample_tokens(logits, *rows)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sampling: unsupported device {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"fused_sampling takes float32 logits, got "
                        f"{logits.dtype}")
    for (name, dtype), x in zip(_ROWS, rows):
        if x.dtype != dtype:
            raise TypeError(f"fused_sampling: {name} must be {dtype}, got "
                            f"{x.dtype}")
    if not all(x.is_contiguous() for x in (logits,) + rows):
        raise ValueError("fused_sampling: operands must be contiguous")
    if min(b, v) < 1:
        raise ValueError(f"fused_sampling: empty logits {tuple(logits.shape)}")
    threads = int(threads)
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    if scratch is not None and (
            tuple(scratch.shape) != (b, 2, v)
            or scratch.dtype != torch.float32
            or scratch.device != logits.device
            or not scratch.is_contiguous()):
        raise ValueError(f"fused_sampling: scratch must be a contiguous "
                         f"({b}, 2, {v}) float32 tensor on {logits.device}, "
                         f"got {tuple(scratch.shape)} {scratch.dtype} on "
                         f"{scratch.device}")
    lib = build.load_library()
    with torch.cuda.device(logits.device):
        if scratch is None:
            scratch = torch.empty((b, 2, v), dtype=torch.float32,
                                  device=logits.device)
        out = torch.empty((b,), dtype=torch.int32, device=logits.device)
        code = lib.fused_sampling_launch(
            logits.data_ptr(), temperature.data_ptr(), seeds.data_ptr(),
            pos.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, v, threads,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "fused_sampling")
    fused_sampling_cuda.launches += 1
    return out


fused_sampling_cuda.launches = 0

"""Wrapper of the fused dynamic-routing CUDA kernel (``csrc/routing.cu``).

Replaces ``repro/kernels/routing/routing_kernel.py`` (``_routing_kernel`` /
``fused_routing_pallas``): all ``n_iters`` routing iterations of an image in
one launch, with the logits, the couplings and the parent capsules in shared
memory throughout.  One thread block serves one image; the tunable is the
number of threads of that block.  The kernel is bound by the bytes of
``u_hat`` (read once per phase, from L2 after the first), see the note at
the head of the source.

:func:`fused_routing_cuda` runs the plain version
(:func:`repro_torch.kernels.routing.ref.fused_routing_ref`) only for a tensor
on the CPU.  For a CUDA tensor it builds the library if need be, launches
the kernel on the current stream and raises on anything the kernel does not
take; nothing falls back.  ``fused_routing_cuda.launches`` counts the kernel
launches of this process.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.routing.ref import fused_routing_ref  # noqa: F401

# Shared memory a block may ask for on Hopper (227 KB of the SM's 256 KB).
MAX_DYNAMIC_SMEM = 232448

_SOFTMAX_MODES = ("exact", "taylor")
_DTYPES = (torch.float32, torch.bfloat16)


def fused_routing_cuda(u_hat: torch.Tensor, n_iters: int = 3,
                       softmax_mode: str = "exact", threads: int = 1024
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_hat (B, I, J, D) -> (v (B, J, D) in u_hat's type, c (B, I, J) f32)."""
    if u_hat.dim() != 4:
        raise ValueError(f"u_hat must be (B, I, J, D), got {tuple(u_hat.shape)}")
    if softmax_mode not in _SOFTMAX_MODES:
        raise ValueError(f"softmax_mode must be one of {_SOFTMAX_MODES}, got "
                         f"{softmax_mode!r}")
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    if u_hat.device.type == "cpu":
        return fused_routing_ref(u_hat, n_iters=n_iters,
                                 softmax_mode=softmax_mode)
    if u_hat.device.type != "cuda":
        raise ValueError(f"fused_routing: unsupported device {u_hat.device}")
    if u_hat.dtype not in _DTYPES:
        raise TypeError(f"fused_routing takes float32 or bfloat16, got "
                        f"{u_hat.dtype}")
    if not u_hat.is_contiguous():
        raise ValueError("fused_routing: u_hat must be contiguous")
    bsz, n_in, n_out, dim = u_hat.shape
    if min(bsz, n_in, n_out, dim) < 1:
        raise ValueError(f"fused_routing: empty dimension in {tuple(u_hat.shape)}")
    threads = int(threads)
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    lib = build.load_library()
    smem = lib.fused_routing_smem_bytes(n_in, n_out, dim, threads)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"fused_routing: I={n_in}, J={n_out}, D={dim} needs {smem} bytes "
            f"of shared memory per block, more than the {MAX_DYNAMIC_SMEM} a "
            f"block can have")
    with torch.cuda.device(u_hat.device):
        v = torch.empty((bsz, n_out, dim), dtype=u_hat.dtype,
                        device=u_hat.device)
        c = torch.empty((bsz, n_in, n_out), dtype=torch.float32,
                        device=u_hat.device)
        code = lib.fused_routing_launch(
            u_hat.data_ptr(), v.data_ptr(), c.data_ptr(), bsz, n_in, n_out,
            dim, int(n_iters), int(softmax_mode == "taylor"),
            int(u_hat.dtype == torch.bfloat16), threads,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "fused_routing")
    fused_routing_cuda.launches += 1
    return v, c


fused_routing_cuda.launches = 0

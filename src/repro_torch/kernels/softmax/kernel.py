"""Wrapper of the Taylor-softmax CUDA kernels (``csrc/softmax.cu``).

Replaces ``repro/kernels/softmax/kernel.py`` (``_softmax_kernel`` /
``taylor_softmax_pallas``): softmax over the last axis with the Eq. 2
polynomial exp, float32 inside.  Rows of at most :data:`WARP_ROW_MAX`
elements take the warp-per-row kernel, longer ones the block-per-row kernel;
the tunable is the number of threads of a block.  Bound by bytes: ``x`` read
once, the result written once.

:func:`taylor_softmax_cuda` runs the plain version
(:func:`repro_torch.kernels.softmax.ref.taylor_softmax_ref`) only for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
``taylor_softmax_cuda.launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.softmax.ref import taylor_softmax_ref  # noqa: F401

WARP_ROW_MAX = 128      # longest row one warp takes
_DTYPES = (torch.float32, torch.bfloat16)


def taylor_softmax_cuda(x: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """Softmax over the last axis of x (any leading shape) using Eq. 2."""
    if x.dim() < 1:
        raise ValueError("taylor_softmax: x needs at least one axis")
    if x.device.type == "cpu":
        return taylor_softmax_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"taylor_softmax: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"taylor_softmax takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("taylor_softmax: x must be contiguous")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    if rows < 1 or n < 1:
        raise ValueError(f"taylor_softmax: empty dimension in {tuple(x.shape)}")
    threads = int(threads)
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    lib = build.load_library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        code = lib.taylor_softmax_launch(
            x.data_ptr(), out.data_ptr(), rows, n,
            int(x.dtype == torch.bfloat16), threads, int(n <= WARP_ROW_MAX),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "taylor_softmax")
    taylor_softmax_cuda.launches += 1
    return out


taylor_softmax_cuda.launches = 0

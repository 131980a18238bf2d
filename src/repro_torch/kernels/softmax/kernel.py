"""Wrapper of the Taylor-softmax CUDA kernels (``csrc/softmax.cu``).

Replaces ``repro/kernels/softmax/kernel.py`` (``_softmax_kernel`` /
``taylor_softmax_pallas``): softmax over the last axis with the Eq. 2
polynomial exp, float32 inside.  Rows of at most :data:`SHORT_ROW_MAX`
elements take the tile kernel (one thread a row out of a shared-memory
tile of :func:`softmax_tile_rows` rows), rows of at most
:data:`WARP_ROW_MAX` the warp-per-row kernel, longer ones the
block-per-row kernel (:func:`softmax_body`); the tunable is the number of
threads of a block (for the tile kernel, the most rows a tile holds).
Bound by bytes: ``x`` read once, the result written once.

:func:`taylor_softmax_cuda` runs the plain version
(:func:`repro_torch.kernels.softmax.ref.taylor_softmax_ref`) only for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
``taylor_softmax_cuda.launches`` counts the kernel launches of this process.

The backward (:func:`taylor_softmax_bwd_cuda`, ``taylor_softmax_bwd_launch``
in the same source) has no TPU kernel to replace: the reference
differentiates its plain-``jnp`` softmax (``repro/core/approx_math.py:65``)
with ``jax.grad``.  An ``x`` that needs a gradient, with autograd on, goes
through :class:`TaylorSoftmax`, whose backward is that kernel (its plain
version, :func:`repro_torch.kernels.softmax.ref.taylor_softmax_bwd_ref`, on
a CPU tensor); ``taylor_softmax_bwd_cuda.launches`` counts its launches.
It is bound by bytes too: ``x`` and the cotangent read once, ``dx`` written
once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.kernel import H100_SMS
from repro_torch.kernels.softmax.ref import (taylor_softmax_bwd_ref,
                                             taylor_softmax_ref)

# kSoftmaxShortMax and kSoftmaxTileBytes of the source (a CPU test holds
# them equal)
SHORT_ROW_MAX = 32      # longest row one thread takes
TILE_BYTES = 32768      # most shared memory a tile uses
WARP_ROW_MAX = 128      # longest row one warp takes
BODIES = ("block", "warp", "tile")      # the C entry's body codes 0, 1, 2
_DTYPES = (torch.float32, torch.bfloat16)


def softmax_body(n: int) -> str:
    """The kernel that takes rows of ``n`` elements."""
    if n <= SHORT_ROW_MAX:
        return "tile"
    return "warp" if n <= WARP_ROW_MAX else "block"


def softmax_tile_rows(rows: int, n: int, elem_bytes: int, threads: int,
                      sms: int = H100_SMS) -> int:
    """Rows of one tile (and threads of its block), a multiple of 32: enough
    that ``rows`` give about one block per SM, at most ``threads`` and
    what :data:`TILE_BYTES` holds of rows of ``n`` elements."""
    cap = min(int(threads), TILE_BYTES // (n * elem_bytes)) // 32 * 32
    per_sm = -(-rows // sms)
    fill = -(-per_sm // 32) * 32
    return max(32, min(cap, fill))


def _check(what: str, x: torch.Tensor, threads: int) -> tuple:
    """Validate a CUDA tensor the kernels take; returns (rows, n, threads,
    body)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    if rows < 1 or n < 1:
        raise ValueError(f"{what}: empty dimension in {tuple(x.shape)}")
    threads = int(threads)
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    return rows, n, threads, softmax_body(n)


def _forward(x: torch.Tensor, threads: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return taylor_softmax_ref(x)
    rows, n, threads, body = _check("taylor_softmax", x, threads)
    if body == "tile":
        threads = softmax_tile_rows(rows, n, x.element_size(), threads)
    index = x.get_device()
    out = torch.empty_like(x)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    code = build.load_library().taylor_softmax_launch(
        x.data_ptr(), out.data_ptr(), rows, n,
        int(x.dtype == torch.bfloat16), threads, BODIES.index(body), vec,
        index, build.raw_stream(index))
    build.check_launch(code, "taylor_softmax")
    taylor_softmax_cuda.launches += 1
    return out


class TaylorSoftmax(torch.autograd.Function):
    """The Eq. 2 softmax with the backward kernel: ``x`` is saved (the
    backward recomputes the maximum, the exps and their sum from it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, threads: int) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.threads = threads
        return _forward(x, threads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return taylor_softmax_bwd_cuda(x, g.to(x.dtype).contiguous(),
                                       threads=ctx.threads), None


def taylor_softmax_cuda(x: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """Softmax over the last axis of x (any leading shape) using Eq. 2;
    differentiable through :class:`TaylorSoftmax` when ``x`` needs a
    gradient."""
    if x.dim() < 1:
        raise ValueError("taylor_softmax: x needs at least one axis")
    if torch.is_grad_enabled() and x.requires_grad:
        return TaylorSoftmax.apply(x, threads)
    return _forward(x, threads)


taylor_softmax_cuda.launches = 0


def taylor_softmax_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                            threads: int = 256) -> torch.Tensor:
    """The gradient of ``taylor_softmax(x)`` against the output cotangent
    ``g`` (same shape and type as ``x``), in ``x``'s type."""
    if x.shape != g.shape or x.dtype != g.dtype or x.device != g.device:
        raise ValueError(
            f"taylor_softmax_bwd: g {tuple(g.shape)} {g.dtype} on "
            f"{g.device} does not match x {tuple(x.shape)} {x.dtype} on "
            f"{x.device}")
    if x.dim() < 1:
        raise ValueError("taylor_softmax_bwd: x needs at least one axis")
    if x.device.type == "cpu":
        return taylor_softmax_bwd_ref(x, g)
    rows, n, threads, body = _check("taylor_softmax_bwd", x, threads)
    if not g.is_contiguous():
        raise ValueError("taylor_softmax_bwd: g must be contiguous")
    if body == "tile":
        # the tile holds x and g side by side
        threads = softmax_tile_rows(rows, n, 2 * x.element_size(), threads)
    index = x.get_device()
    dx = torch.empty_like(x)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x, g, dx)))
    code = build.load_library().taylor_softmax_bwd_launch(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, n,
        int(x.dtype == torch.bfloat16), threads, BODIES.index(body), vec,
        index, build.raw_stream(index))
    build.check_launch(code, "taylor_softmax_bwd")
    taylor_softmax_bwd_cuda.launches += 1
    return dx


taylor_softmax_bwd_cuda.launches = 0

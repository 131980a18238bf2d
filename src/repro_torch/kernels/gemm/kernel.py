"""Wrapper of the fixed-order matrix product (``csrc/gemm.cu``).

Replaces no TPU kernel: the reference leaves its projections to XLA's dot.
It was added because cuBLAS chooses its tile, split-K and reduction order
from M, so a request's rows took other bits when other rows shared the
call (ROADMAP §C Open 1).  :func:`fixed_order_matmul_cuda` computes
``y = x @ w`` for x (M, K) and w (K, N) with one CTA tile, one instruction
shape and one K order for every M (:func:`gemm_plan` reads no M): a row's
bits depend only on that row of x and on w.  bf16 operands take the
Hopper body: TMA copies into a ring of swizzled shared-memory stages, one
producer warp, two consumer warpgroups issuing ``wgmma`` m64n<BN>k16 with
float32 accumulation, one rounding to bf16; BN comes from N
(:func:`gemm_block_n`), never from M.  float32 operands take the
FMA body, K in ascending order.  At a decode tick's M the rows past M are
the copies' zero fill, and a consumer warpgroup with no row below M
issues nothing: each stored row gets the same instructions in the same
order at every M, so the same bits.

``w`` is read as stored: a contiguous (K, N) matrix (``kn``, a projection's
weight, N contiguous; the (d, h, k) and (h, k, d) attention weights flatten
to it as views) or the transpose of a contiguous (N, K) one (``nk``, a tied
embedding table's ``.T``).  No copy is made of it.

The wrapper runs the plain version (:func:`fixed_order_matmul_plain`,
``torch.matmul``) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  Given meta tensors (a dry run) it checks what the
kernel would check, returns an empty output and charges its row's cost
(:mod:`repro_torch.launch.roofline`).  It has no backward: a gradient is
refused (``build.refuse_grad``); the models take it only when no gradient
is asked for.  ``fixed_order_matmul_cuda.launches`` counts the kernel
launches of this process, ``launches_by_body`` them by body.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.limits import MAX_GRID_YZ

# The source's geometry (kGemmBM, kGemmBK, kGemmConsumers, kGemmThreads,
# kGemmStagesN<BN>, kGemmF32Tile, kGemmF32K; a CPU test holds them equal)
GEMM_BM, GEMM_BK = 128, 64
GEMM_CONSUMERS = 2          # consumer warpgroups, one 64-row wgmma each
GEMM_THREADS = 384          # the consumers, then the producer's warpgroup
GEMM_STAGES = {64: 8, 128: 7, 256: 4}     # stages in the ring, by BN
GEMM_F32_TILE, GEMM_F32_K = 64, 16
GEMM_F32_THREADS = 256
GEMM_BODIES = ("tensor_core", "fma")
GEMM_ALIGN = 8              # bf16 elements of 16 bytes (a tensor map's rule)

GEMM_HINT = ("the models take it only when no gradient is asked for; "
             "train through the plain products")


def gemm_body(dtype: torch.dtype) -> str:
    """The body a type takes: ``tensor_core`` for bfloat16, ``fma`` for
    float32."""
    return "tensor_core" if dtype == torch.bfloat16 else "fma"


def w_layout(w: torch.Tensor) -> str:
    """How (K, N) ``w`` lies in memory: ``kn`` (row-major, N contiguous),
    ``nk`` (the transpose of a row-major (N, K) matrix) or ``strided``
    (neither: the kernel refuses it)."""
    k, n = w.shape
    if w.stride(1) == 1 and (w.stride(0) == n or k == 1):
        return "kn"
    if w.stride(0) == 1 and (w.stride(1) == k or n == 1):
        return "nk"
    return "strided"


def gemm_block_n(n: int) -> int:
    """The bf16 CTA's columns, which are the ``wgmma`` instruction's N: a
    function of N, never of M (the source's
    ``gemm_block_n``, which a CPU test holds equal).  The widest of 256,
    128 and 64 that still cuts N into at least 16 column tiles, else 64: a
    wide product takes the tile that runs a prefill fastest, a narrow one
    more CTAs to stream its w at a decode tick."""
    if n >= 16 * 256:
        return 256
    if n >= 16 * 128:
        return 128
    return 64


def gemm_smem(bn: int) -> int:
    """The bf16 body's dynamic shared memory at BN ``bn``: 1024 bytes to
    align the ring, then each stage's A tile (128 x 64), B tile (BN x 64)
    and two 8-byte mbarriers."""
    return 1024 + GEMM_STAGES[bn] * (2 * GEMM_BK * (GEMM_BM + bn) + 16)


def gemm_plan(x: torch.Tensor, w: torch.Tensor) -> Dict[str, object]:
    """What decides the bits of an output row: the body, the CTA tile, the
    instruction, the K step and order, the pipeline depth and w's layout.
    A function of the types, N, K and the layout only; it reads no M (the
    rows of x), so a row gets the same sums at every M."""
    body = gemm_body(x.dtype)
    layout = w_layout(w)
    k, n = int(w.shape[0]), int(w.shape[1])
    if body == "tensor_core":
        bn = gemm_block_n(n)
        tile = (GEMM_BM, bn, GEMM_BK)
        mma, stages = f"wgmma m64n{bn}k16", GEMM_STAGES[bn]
        threads = GEMM_THREADS
    else:
        tile = (GEMM_F32_TILE, GEMM_F32_TILE, GEMM_F32_K)
        mma, stages, threads = "fmaf", 1, GEMM_F32_THREADS
    return {"body": body, "tile": tile, "instruction": mma,
            "k_order": "ascending", "split_k": 1, "stages": stages,
            "threads": threads, "layout": layout, "n": n, "k": k}


def gemm_grid(m: int, n: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The source's grid: a CTA per output tile, N tiles on x, M tiles on
    y."""
    if gemm_body(dtype) == "tensor_core":
        bm, bn = GEMM_BM, gemm_block_n(n)
    else:
        bm = bn = GEMM_F32_TILE
    return (-(-n // bn), -(-m // bm), 1)


def check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    """What every device refuses: other than 2-D operands whose K agree."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fixed_order_matmul: x must be (M, K) and w "
                         f"(K, N), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def check_kernel(x: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernel refuses besides (on the card and on meta): another
    type than bfloat16 or float32, mixed types, a w that is neither
    layout, a non-contiguous x, an empty dimension, bf16 N or K not a
    multiple of 8, or more row tiles than the grid's axis y holds."""
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"fixed_order_matmul takes bfloat16 or float32 x "
                        f"and w of one type, got {x.dtype} and {w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"fixed_order_matmul: empty dimension in "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("fixed_order_matmul: x must be contiguous")
    if w_layout(w) == "strided":
        raise ValueError(f"fixed_order_matmul: w {tuple(w.shape)} with "
                         f"strides {w.stride()} is neither row-major nor "
                         f"the transpose of a row-major matrix")
    if x.dtype == torch.bfloat16 and (n % GEMM_ALIGN or k % GEMM_ALIGN):
        raise ValueError(f"fixed_order_matmul: bf16 N {n} and K {k} must "
                         f"be multiples of {GEMM_ALIGN} (16-byte rows)")
    if gemm_grid(m, n, x.dtype)[1] > MAX_GRID_YZ:
        raise ValueError(f"fixed_order_matmul: {m} rows need more than "
                         f"{MAX_GRID_YZ} row tiles")


def fixed_order_matmul_plain(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """The plain version: ``x @ w``."""
    return torch.matmul(x, w)


_launch = None                      # the C entry point, bound at first use


def _launch_fn():
    global _launch
    if _launch is None:
        _launch = build.load_library().fixed_order_matmul_launch
    return _launch


def fixed_order_matmul_cuda(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's type, with one tile and one K
    order for every M (a CPU tensor takes the plain version)."""
    build.refuse_grad("fixed_order_matmul", x, w, hint=GEMM_HINT)
    check_shapes(x, w)
    kind = x.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fixed_order_matmul: unsupported device "
                         f"{x.device}")
    if w.device != x.device:
        raise ValueError(f"fixed_order_matmul: x on {x.device}, w on "
                         f"{w.device}")
    if kind == "cpu":
        return fixed_order_matmul_plain(x, w)
    check_kernel(x, w)
    m, k = x.shape
    n = w.shape[1]
    if kind == "meta":
        from repro_torch.launch import roofline

        roofline.add_kernel_cost("fixed_order_matmul", {
            "dims": (m, n, k),
            "dtype": "bfloat16" if x.dtype == torch.bfloat16
            else "float32"})
        return torch.empty((m, n), dtype=x.dtype, device="meta")
    body = gemm_body(x.dtype)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fixed_order_matmul: x and w must start on a "
                         "16-byte boundary")
    index = x.get_device()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    code = _launch_fn()(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
        int(w_layout(w) == "nk"), int(body == "tensor_core"), index,
        build.raw_stream(index))
    build.check_launch(code, f"fixed_order_matmul ({body})")
    fixed_order_matmul_cuda.launches += 1
    fixed_order_matmul_cuda.launches_by_body[body] += 1
    return y


fixed_order_matmul_cuda.launches = 0
fixed_order_matmul_cuda.launches_by_body = dict.fromkeys(GEMM_BODIES, 0)

"""Wrapper of the fused sampling CUDA kernel (``csrc/sampling.cu``).

Replaces ``repro/kernels/sampling/kernel.py`` (``_fused_sampling_kernel`` /
``fused_sampling_pallas``): temperature, top-k, top-p and the counter-based
Gumbel draw of every row of a serving tick in one launch, so only the
(B,) int32 tokens leave the card.  One thread-block cluster serves one row:
its ``cluster`` blocks each keep a slice of the row's scaled logits and
probabilities in shared memory and reduce over distributed shared memory,
so the kernel needs no work space in device memory.  The tunables are the
cluster size and the threads per block (:func:`plan_cluster` legalizes
them).

:func:`fused_sampling_cuda` runs the plain version
(:func:`repro_torch.kernels.sampling.ref.sample_tokens`) only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises.  Given meta
tensors (a dry run) it checks what the kernel would check, returns empty
tokens on the meta device and charges its kernel-table row's cost
(:mod:`repro_torch.launch.roofline`) to the active cost counter, each row
counted as a draw at temperature 1 (a meta row's values cannot be read).
``fused_sampling_cuda.launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sampling.ref import sample_tokens

# The kernel's geometry (kSampleLevels, kSampleVals, kSampleMaxWarps,
# kSampleMaxCluster and kSampleMaxSmem of the source; a CPU test holds them
# equal), which the registry needs to plan cluster sizes on hosts without
# the library.
SAMPLE_LEVELS = 3            # bisection steps a pass
SAMPLE_VALS = 16             # values a block publishes to its cluster
SAMPLE_MAX_WARPS = 32
SAMPLE_MAX_CLUSTER = 8       # the portable cluster size limit
MAX_DYNAMIC_SMEM = 232448    # bytes a Hopper block may ask for
CLUSTER_SIZES = (1, 2, 4, 8)

# per-row operands: name, dtype
_ROWS = (("temperature", torch.float32), ("seeds", torch.int32),
         ("pos", torch.int32), ("top_k", torch.int32),
         ("top_p", torch.float32))


def sampling_slice(v: int, cluster: int) -> int:
    """Elements of a row one block of a ``cluster`` keeps: ceil(V /
    cluster) rounded up to a float4 group (``sampling_slice`` of the
    source)."""
    return (-(-v // cluster) + 3) // 4 * 4


def sampling_smem_bytes(v: int, cluster: int) -> int:
    """Shared memory of one block, as ``sampling_smem_floats`` sizes it:
    the slice's z and probabilities, ``SAMPLE_VALS`` partials per warp, two
    publication slots, the totals, and the blocks' argmaxes for rank 0."""
    return 4 * (2 * sampling_slice(v, cluster)
                + (SAMPLE_MAX_WARPS + 3) * SAMPLE_VALS
                + 2 * SAMPLE_MAX_CLUSTER)


def _too_long(v: int, cluster: int) -> ValueError:
    return ValueError(f"fused_sampling: a row of {v} logits over {cluster} "
                      f"blocks needs {sampling_smem_bytes(v, cluster)} bytes "
                      f"of shared memory per block, more than the "
                      f"{MAX_DYNAMIC_SMEM} a block can have")


def plan_cluster(v: int, cluster: int, threads: int) -> int:
    """The cluster size for rows of ``v`` logits: the largest power of two
    up to the one asked for whose slice still gives every thread a float4
    group (so small rows run on one block), raised to the smallest whose
    slice fits a block's shared memory.  Raises ``ValueError`` for a row
    that does not fit even ``SAMPLE_MAX_CLUSTER`` blocks (more than 230144
    logits)."""
    asked = max(1, min(int(cluster), SAMPLE_MAX_CLUSTER))
    c = 1
    while 2 * c <= asked and sampling_slice(v, 2 * c) // 4 >= threads:
        c *= 2
    while sampling_smem_bytes(v, c) > MAX_DYNAMIC_SMEM:
        if c == SAMPLE_MAX_CLUSTER:
            raise _too_long(v, c)
        c *= 2
    return c


def _check(logits: torch.Tensor, rows: tuple) -> None:
    """Shapes and devices, with a message naming the operand at fault."""
    if logits.dim() != 2:
        raise ValueError(f"fused_sampling: logits must be (B, V), got "
                         f"{tuple(logits.shape)}")
    shape = logits.shape[:1]
    cuda, index = logits.is_cuda, logits.get_device()
    for (name, _), x in zip(_ROWS, rows):
        if x.shape != shape:
            raise ValueError(f"fused_sampling: {name} must be "
                             f"({shape[0]},), got {tuple(x.shape)}")
        # a CUDA index differs from every other device's (-1); off the
        # card the device types are compared too (cpu against meta)
        if x.get_device() != index or (not cuda and x.device != logits.device):
            raise ValueError(f"fused_sampling: {name} on {x.device}, logits "
                             f"on {logits.device}")


def _check_cuda(logits: torch.Tensor, rows: tuple, cluster: int,
                threads: int) -> None:
    """What the kernel needs of CUDA operands and of its launch shape."""
    if logits.dtype is not torch.float32:
        raise TypeError(f"fused_sampling takes float32 logits, got "
                        f"{logits.dtype}")
    for (name, dtype), x in zip(_ROWS, rows):
        if x.dtype is not dtype:
            raise TypeError(f"fused_sampling: {name} must be {dtype}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"fused_sampling: {name} must be contiguous")
    if not logits.is_contiguous():
        raise ValueError("fused_sampling: logits must be contiguous")
    b, v = logits.shape
    if b < 1 or v < 1:
        raise ValueError(f"fused_sampling: empty logits {tuple(logits.shape)}")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"fused_sampling: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    if sampling_smem_bytes(v, cluster) > MAX_DYNAMIC_SMEM:
        raise _too_long(v, cluster)


_launch = None                      # the C entry point, bound at first use


def _launch_fn():
    global _launch
    if _launch is None:
        _launch = build.load_library().fused_sampling_launch
    return _launch


def fused_sampling_cuda(logits: torch.Tensor, temperature: torch.Tensor,
                        seeds: torch.Tensor, pos: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        cluster: int = 8, threads: int = 512
                        ) -> torch.Tensor:
    """logits (B, V) float32; temperature, top_p (B,) float32; seeds, pos,
    top_k (B,) int32 -> (B,) int32 tokens.  ``cluster`` blocks serve a row
    (one of :data:`CLUSTER_SIZES`, its slice within a block's shared
    memory), each of ``threads`` threads."""
    rows = (temperature, seeds, pos, top_k, top_p)
    _check(logits, rows)
    if not logits.is_cuda:
        if logits.device.type == "cpu":
            return sample_tokens(logits, *rows)
        if logits.device.type != "meta":
            raise ValueError(f"fused_sampling: unsupported device "
                             f"{logits.device}")
    cluster, threads = int(cluster), int(threads)
    _check_cuda(logits, rows, cluster, threads)
    if logits.device.type == "meta":
        # the rows' values cannot be read on meta: each row is counted as
        # a draw at temperature 1 without top-k or top-p
        from repro_torch.launch import roofline

        roofline.add_kernel_cost("fused_sampling",
                                 {"dims": tuple(logits.shape)})
        return torch.empty((logits.shape[0],), dtype=torch.int32,
                           device="meta")
    index = logits.get_device()
    b, v = logits.shape
    ptr = logits.data_ptr()
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    code = _launch_fn()(
        ptr, temperature.data_ptr(), seeds.data_ptr(), pos.data_ptr(),
        top_k.data_ptr(), top_p.data_ptr(), out.data_ptr(), b, v, cluster,
        threads, int(v % 4 == 0 and ptr % 16 == 0), index,
        build.raw_stream(index))
    build.check_launch(code, "fused_sampling")
    fused_sampling_cuda.launches += 1
    return out


fused_sampling_cuda.launches = 0

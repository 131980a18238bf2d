"""Wrapper of the fused dynamic-routing CUDA kernel (``csrc/routing.cu``).

Replaces ``repro/kernels/routing/routing_kernel.py`` (``_routing_kernel`` /
``fused_routing_pallas``): all ``n_iters`` routing iterations of an image in
one launch.  One thread-block cluster serves one image: its ``i_splits``
blocks each own a contiguous range of the input capsules, copy that slice of
``u_hat`` into shared memory once, keep its rows of the logits and the
couplings there, and join their partial sums over distributed shared memory
in rank order.  So device memory sees one read of ``u_hat`` and one write
of ``v`` and ``c``; see the note at the head of the source.  The tunables
are ``i_splits`` (1, 2, 4 or 8, the portable cluster sizes; 0 asks
:func:`plan_i_splits`) and the threads per block.

:func:`fused_routing_cuda` runs the plain version
(:func:`repro_torch.kernels.routing.ref.fused_routing_ref`) only for a tensor
on the CPU.  For a CUDA tensor it builds the library if need be, launches
the kernel on the current stream and raises on anything the kernel does not
take; nothing falls back.  Given a meta ``u_hat`` (a dry run) it checks
what the kernel would check, returns empty ``v`` and ``c`` on the meta
device and charges its kernel-table row's cost
(:mod:`repro_torch.launch.roofline`) to the active cost counter; nothing
is launched.  ``fused_routing_cuda.launches`` counts the kernel
launches of this process, and ``launches_by_splits`` the same by cluster
size.  The kernel has no backward: a ``u_hat`` that needs a gradient, with
autograd on, is refused on every device (``build.refuse_grad``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.kernel import H100_SMS
from repro_torch.kernels.limits import MAX_CLUSTER, MAX_DYNAMIC_SMEM
from repro_torch.kernels.routing.ref import fused_routing_ref

# The kernel's geometry (kRoutingMaxCluster, kRoutingMaxThreads,
# kRoutingMaxSmem and kRoutingBarBytes of the source; a CPU test holds them
# equal), which plans cluster sizes on hosts without the library.  The
# cluster and shared-memory limits are Hopper's (repro_torch.kernels.limits).
ROUTING_MAX_CLUSTER = MAX_CLUSTER
ROUTING_MAX_THREADS = 1024
SM_SMEM = 233472                 # shared memory of an SM (228 KB)
BLOCK_RESERVED_SMEM = 1024       # what the SM keeps of it for each block
ROUTING_BAR_BYTES = 16
I_SPLITS = (1, 2, 4, 8)

_SOFTMAX_MODES = ("exact", "taylor")
_DTYPES = (torch.float32, torch.bfloat16)


def routing_rows(n_in: int, splits: int) -> int:
    """Input capsules of a cluster's largest rank (``routing_rows``)."""
    return -(-n_in // splits)


def routing_smem_bytes(n_in: int, n_out: int, dim: int, elem_bytes: int,
                       splits: int) -> int:
    """Shared memory of one block, as ``routing_smem_bytes`` of the source
    sizes it: the mbarrier, the rows' ``u_hat`` slice in its own type,
    float32 logits and couplings of the rows (each padded to 16 bytes), the
    thread groups' partial sums, two publication slots, ``s`` / ``v`` and
    the squash factors."""
    rows = routing_rows(n_in, splits)
    jd = n_out * dim
    slice_bytes = -(-rows * jd * elem_bytes // 16) * 16
    rows_j = -(-rows * n_out // 4) * 4
    floats = 2 * rows_j + max(jd, ROUTING_MAX_THREADS) + 3 * jd + n_out
    return ROUTING_BAR_BYTES + slice_bytes + 4 * floats


def max_input_capsules(n_out: int, dim: int, elem_bytes: int) -> int:
    """The most input capsules a cluster of ``ROUTING_MAX_CLUSTER`` blocks
    holds at these J, D and element size."""
    lo, hi = 0, 1
    while routing_smem_bytes(hi, n_out, dim, elem_bytes,
                             ROUTING_MAX_CLUSTER) <= MAX_DYNAMIC_SMEM:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if routing_smem_bytes(mid, n_out, dim, elem_bytes,
                              ROUTING_MAX_CLUSTER) <= MAX_DYNAMIC_SMEM:
            lo = mid
        else:
            hi = mid
    return lo


def _too_large(i: int, j: int, d: int, elem_bytes: int, splits: int
               ) -> ValueError:
    return ValueError(
        f"fused_routing: I={i}, J={j}, D={d} at {elem_bytes} bytes an "
        f"element needs {routing_smem_bytes(i, j, d, elem_bytes, splits)} "
        f"bytes of shared memory per block over {splits} blocks, more than "
        f"the {MAX_DYNAMIC_SMEM} a block can have (at most "
        f"{max_input_capsules(j, d, elem_bytes)} input capsules over "
        f"{ROUTING_MAX_CLUSTER} blocks)")


def two_per_sm(smem_bytes: int) -> bool:
    """Whether two blocks of this shared memory fit one SM together."""
    return 2 * (smem_bytes + BLOCK_RESERVED_SMEM) <= SM_SMEM


def plan_i_splits(b: int, i: int, j: int, d: int, elem_bytes: int,
                  asked: int = 0, sms: int = H100_SMS) -> int:
    """The cluster size for ``u_hat`` (b, i, j, d).  A size ``asked`` (a
    tuned one, rounded down to a power of two up to 8) is kept if its
    slice fits a block's shared memory, and raised to the smallest that
    fits if not.  With ``asked`` 0, of the sizes that fit and give every
    block a capsule: the smallest that gives ``b * size`` blocks on at
    least three quarters of the ``sms`` (the power-of-two count nearest one
    block an SM) and leaves room for a second block on the SM (two blocks
    of an SM hide each other's barrier waits: at (32, 1152, 10, 16) float32,
    8 blocks of 110 KB beat 4 of 213 KB on the H100); else the smallest
    that fills the SMs; else the largest.  Raises ``ValueError`` when ``i``
    fits no cluster."""
    fits = [s for s in I_SPLITS
            if routing_smem_bytes(i, j, d, elem_bytes, s) <= MAX_DYNAMIC_SMEM]
    if not fits:
        raise _too_large(i, j, d, elem_bytes, ROUTING_MAX_CLUSTER)
    asked = min(int(asked), ROUTING_MAX_CLUSTER)
    if asked > 0:
        return max(1 << (asked.bit_length() - 1), fits[0])
    useful = [s for s in fits if s <= i] or fits[:1]
    filling = [s for s in useful if 4 * b * s >= 3 * sms]
    for s in filling:
        if two_per_sm(routing_smem_bytes(i, j, d, elem_bytes, s)):
            return s
    return filling[0] if filling else useful[-1]


def _check_cuda(u_hat: torch.Tensor, i_splits: int, threads: int) -> None:
    """What the kernel needs of a CUDA ``u_hat`` and of its launch shape."""
    if u_hat.dtype not in _DTYPES:
        raise TypeError(f"fused_routing takes float32 or bfloat16, got "
                        f"{u_hat.dtype}")
    if not u_hat.is_contiguous():
        raise ValueError("fused_routing: u_hat must be contiguous")
    bsz, n_in, n_out, dim = u_hat.shape
    if min(bsz, n_in, n_out, dim) < 1:
        raise ValueError(f"fused_routing: empty dimension in "
                         f"{tuple(u_hat.shape)}")
    if threads % 32 or not 32 <= threads <= ROUTING_MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{ROUTING_MAX_THREADS}], got {threads}")
    if i_splits not in I_SPLITS:
        raise ValueError(f"fused_routing: i_splits must be one of "
                         f"{I_SPLITS} or 0 (planned), got {i_splits}")
    elem = u_hat.element_size()
    if routing_smem_bytes(n_in, n_out, dim, elem, i_splits) > MAX_DYNAMIC_SMEM:
        raise _too_large(n_in, n_out, dim, elem, i_splits)


_launch = None                      # the C entry point, bound at first use


def _launch_fn():
    global _launch
    if _launch is None:
        _launch = build.load_library().fused_routing_launch
    return _launch


def fused_routing_cuda(u_hat: torch.Tensor, n_iters: int = 3,
                       softmax_mode: str = "exact", i_splits: int = 0,
                       threads: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_hat (B, I, J, D) -> (v (B, J, D) in u_hat's type, c (B, I, J) f32).
    ``i_splits`` blocks serve an image (one of :data:`I_SPLITS`, its slice
    within a block's shared memory; 0 takes :func:`plan_i_splits`'s), each
    of ``threads`` threads."""
    if u_hat.dim() != 4:
        raise ValueError(f"u_hat must be (B, I, J, D), got {tuple(u_hat.shape)}")
    if softmax_mode not in _SOFTMAX_MODES:
        raise ValueError(f"softmax_mode must be one of {_SOFTMAX_MODES}, got "
                         f"{softmax_mode!r}")
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    build.refuse_grad("fused_routing", u_hat)
    if u_hat.device.type == "cpu":
        return fused_routing_ref(u_hat, n_iters=n_iters,
                                 softmax_mode=softmax_mode)
    if u_hat.device.type not in ("cuda", "meta"):
        raise ValueError(f"fused_routing: unsupported device {u_hat.device}")
    bsz, n_in, n_out, dim = u_hat.shape
    i_splits, threads = int(i_splits), int(threads)
    if i_splits == 0 and u_hat.dtype in _DTYPES:
        i_splits = plan_i_splits(bsz, n_in, n_out, dim, u_hat.element_size())
    _check_cuda(u_hat, i_splits, threads)
    if u_hat.device.type == "meta":
        from repro_torch.launch import roofline

        roofline.add_kernel_cost("fused_routing", {
            "shape": tuple(u_hat.shape), "n_iters": int(n_iters),
            "softmax_mode": softmax_mode,
            "dtype": ("bfloat16" if u_hat.dtype == torch.bfloat16
                      else "float32")})
        return (torch.empty((bsz, n_out, dim), dtype=u_hat.dtype,
                            device="meta"),
                torch.empty((bsz, n_in, n_out), dtype=torch.float32,
                            device="meta"))
    index = u_hat.get_device()
    v = torch.empty((bsz, n_out, dim), dtype=u_hat.dtype, device=u_hat.device)
    c = torch.empty((bsz, n_in, n_out), dtype=torch.float32,
                    device=u_hat.device)
    code = _launch_fn()(
        u_hat.data_ptr(), v.data_ptr(), c.data_ptr(), bsz, n_in, n_out, dim,
        int(n_iters), int(softmax_mode == "taylor"),
        int(u_hat.dtype == torch.bfloat16), i_splits, threads, index,
        build.raw_stream(index))
    build.check_launch(code, "fused_routing")
    fused_routing_cuda.launches += 1
    fused_routing_cuda.launches_by_splits[i_splits] += 1
    return v, c


fused_routing_cuda.launches = 0
fused_routing_cuda.launches_by_splits = dict.fromkeys(I_SPLITS, 0)

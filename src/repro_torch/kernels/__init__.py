"""CUDA kernel subsystem: registry-dispatched, autotunable kernels.

Every kernel of the port is written by hand for Hopper (``csrc/*.cu``),
built at first use (:mod:`repro_torch.kernels.build`), and registered once
in :mod:`repro_torch.kernels.registry` as a typed :class:`KernelSpec` —
wrapper, plain PyTorch version, tunable launch geometry — and dispatched
through :data:`registry` (or the ergonomic wrappers re-exported here).
A wrapper runs its plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from repro_torch.kernels import tuning  # noqa: F401
from repro_torch.kernels.registry import (KernelRegistry,  # noqa: F401
                                          KernelSpec, decode_attention,
                                          flash_attention,
                                          flash_attention_dequant,
                                          fixed_order_matmul,
                                          fused_routing,
                                          fused_sampling,
                                          fused_sampling_rows,
                                          pack_sampling_rows, registry,
                                          taylor_softmax,
                                          taylor_softmax_bwd)

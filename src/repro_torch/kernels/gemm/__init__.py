"""The fixed-order matrix product (``csrc/gemm.cu``): a bf16 / float32 GEMM
whose output rows do not depend on M.  Dispatch lives in
:mod:`repro_torch.kernels.registry` (``fixed_order_matmul``); this package
keeps the wrapper, its plan and its plain version."""

from repro_torch.kernels.gemm.kernel import (fixed_order_matmul_cuda,
                                             fixed_order_matmul_plain,
                                             gemm_plan)

__all__ = ["fixed_order_matmul_cuda", "fixed_order_matmul_plain",
           "gemm_plan"]

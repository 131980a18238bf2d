# Dispatch lives in repro_torch.kernels.registry ("fused_sampling"); this
# package keeps the kernel's wrapper, its plain version and the host path.
from repro_torch.kernels.sampling.kernel import fused_sampling_cuda
from repro_torch.kernels.sampling.ref import (fused_sampling_ref,
                                              sample_token_host, sample_tokens)

__all__ = ["fused_sampling_cuda", "fused_sampling_ref", "sample_token_host",
           "sample_tokens"]

# Dispatch lives in repro_torch.kernels.registry ("fused_routing"); this
# package keeps the kernel's wrapper and its plain PyTorch version.
from repro_torch.kernels.routing.ref import fused_routing_ref  # noqa: F401
from repro_torch.kernels.routing.routing_kernel import fused_routing_cuda  # noqa: F401

# Dispatch lives in repro_torch.kernels.registry ("taylor_softmax"); this
# package keeps the kernel's wrapper and its plain PyTorch version.
from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda  # noqa: F401
from repro_torch.kernels.softmax.ref import taylor_softmax_ref  # noqa: F401

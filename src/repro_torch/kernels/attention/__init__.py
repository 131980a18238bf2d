# Dispatch lives in repro_torch.kernels.registry ("flash_attention",
# "decode_attention"); this package keeps the kernels' wrappers, their plain
# PyTorch versions and the oracles.
from repro_torch.kernels.attention import ref  # noqa: F401
from repro_torch.kernels.attention.kernel import (  # noqa: F401
    decode_attention_cuda, flash_attention_cuda)

"""FastCaps on PyTorch and CUDA: the port of the ``repro`` package (JAX,
TPU) for an NVIDIA H100.

Same sub-packages as the reference (``core``, ``kernels``, ``deploy``,
``models``, ``configs``, ``serving``, ``launch``), so the two trees can be
read side by side.  The package imports ``torch`` and ``numpy`` only.  Its
entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when there is none; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

from repro_torch.device import resolve_device  # noqa: F401

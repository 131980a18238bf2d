"""Hopper's launch limits, written once for the kernel wrappers, the
registry's legalizers and capslint's ``kernel-legality`` rule
(:mod:`repro_torch.analysis.checkers.legality`).

The CUDA sources keep their own ``constexpr`` copies (``kRoutingMaxSmem``,
``kDecodeMaxSmem``, ``kSampleMaxSmem``; ``kRoutingMaxCluster``,
``kDecodeMaxSplits``, ``kSampleMaxCluster``, ``kFlashMaxGridX``), which a
CPU test reads out of ``csrc/`` and holds equal to these.
"""

#: bytes of dynamic shared memory one block may ask for on an H100 (227 KB
#: of the SM's 228 KB; ``cudaFuncAttributeMaxDynamicSharedMemorySize``)
MAX_DYNAMIC_SMEM = 232448
#: blocks of a thread-block cluster: the portable limit (16 would need
#: ``cudaFuncAttributeNonPortableClusterSizeAllowed``)
MAX_CLUSTER = 8
#: threads of a warp, and of a block at most
WARP = 32
MAX_THREADS = 1024
#: blocks of a grid on axis x, and on axes y and z (``cudaDevAttrMaxGridDimX``
#: / ``Y`` / ``Z`` of compute capability 3.0 and later; ``chip_smoke.py``
#: reads the card's own)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535

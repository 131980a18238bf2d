"""The port's counted ``dot_flops`` of a train step (``autograd.grad`` and
AdamW, through ``repro_torch.launch.dryrun``'s cell) against the
reference's compiled train step, for the reduced config of each LM family
at batch 4 x 128 positions on a 1x1 mesh (the helpers and the hybrid's
``lax.cond`` difference are ``tests/test_torch_op_cost.py``'s).

The port counts 0.90-1.0 of the reference's products: the reference runs
its attention scan under ``jax.checkpoint`` (``attn_scan_remat``), so its
backward recomputes every QK and PV block, while the port's chunked
attention keeps them for autograd; the port's cross-entropy chunk is
recomputed in its backward (``loss_remat``, counted) where XLA drops the
duplicate of an unscanned ``jax.checkpoint``.  ROADMAP section C records
both.
"""

import pytest
import torch

from test_torch_op_cost import FAMILY_ARCHS, port_dot_flops, ref_dot_flops

torch.set_num_threads(1)

BATCH, SEQ = 4, 128


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_dot_flops_match_reference(arch):
    ref = ref_dot_flops(arch, "train", BATCH, SEQ)
    port = port_dot_flops(arch, "train", BATCH, SEQ)
    if arch == "zamba2-1.2b":
        # the reference charges lax.cond's shared block at every layer
        assert 0.35 < port / ref < 0.45, port / ref
    else:
        assert 0.90 < port / ref <= 1.0, port / ref

"""capsnet-mnist — the paper's own architecture (Sabour et al. [4], Fig. 3).

Conv1 9x9/256 -> PrimaryCaps 9x9 s2 (32 types x 8D = 1152 capsules) ->
DigitCaps (10 x 16D, 3 routing iterations) + FC decoder 512/1024/784.

The FastCaps deployment config (pruned + optimized) is derived from this
via ``repro_torch.deploy.FastCapsPipeline`` at the paper's sparsity (conv2
kernels pruned until 7/32 capsule types survive -> 252 capsules) with the
typed ``RoutingSpec.cuda(softmax="taylor")`` routing.
"""

import dataclasses as _dc

from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.deploy import RoutingSpec

CONFIG = CapsNetConfig(
    arch_id="capsnet-mnist",
    image_hw=28,
    in_channels=1,
    n_classes=10,
    conv1_channels=256,
    caps_types=32,
    caps_dim=8,
    digit_dim=16,
    routing_iters=3,
    routing=RoutingSpec.reference(),
)

# FastCaps deployment variant (paper §III-B optimizations on)
OPTIMIZED = _dc.replace(CONFIG, routing=RoutingSpec.cuda(softmax="taylor"))

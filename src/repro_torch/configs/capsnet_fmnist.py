"""capsnet-fmnist — same architecture, F-MNIST-shaped task (28x28x1, 10
classes).  Paper: pruning keeps 12/32 capsule types (432 capsules)."""

from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.deploy import RoutingSpec

CONFIG = CapsNetConfig(
    arch_id="capsnet-fmnist",
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

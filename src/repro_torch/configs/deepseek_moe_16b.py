"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff=1408
(per expert) vocab=102400; 2 shared + 64 routed experts, top-6,
fine-grained.  [arXiv:2401.06066]

Deviation, as in the reference's config: the real model's first layer is
a dense FFN; here all 28 layers are MoE, so the stack is homogeneous
(<2% parameter deviation).

long_500k: SKIP — full attention.
"""

from repro_torch.models.common import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  capacity_factor=1.25),
    rope_theta=10000.0,
    loss_chunks=8,
)

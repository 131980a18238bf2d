"""zamba2-1.2b [hybrid]: Mamba-2 backbone + ONE shared attention+MLP block
applied every 6th layer (weights shared across all 6 application sites).
38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000 ssm_state=64.
[arXiv:2411.15242; hf]

long_500k: RUNS — the backbone state is O(1); the shared-attn KV grows
linearly but decode cost per token is linear in KV, not quadratic.
"""

from repro_torch.models.common import LMConfig, SSMConfig

CONFIG = LMConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    hybrid_attn_every=6,
    rope_theta=10000.0,
    remat_group=2,
)

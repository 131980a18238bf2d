"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per
expert) vocab=100352; 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base]

long_500k: SKIP — full attention.
"""

from repro_torch.models.common import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752, n_shared=0,
                  capacity_factor=1.25),
    rope_theta=500000.0,
    remat_group=4,
    loss_chunks=8,
)

"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk-norm.  [hf:Qwen/Qwen3-1.7B family]

long_500k: SKIP — pure full attention.
"""

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    d_head=128,
    rope_theta=1000000.0,
    loss_chunks=8,
)

"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]

long_500k: SKIP — pure full attention.
"""

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1000000.0,
    remat_group=4,
    loss_chunks=8,
)

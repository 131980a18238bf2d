"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings.  [hf:meta-llama/Llama-3.2-1B]

long_500k: SKIP — pure full attention.
"""

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
    loss_chunks=8,
)

"""llama-3.2-vision-90b [vlm]: 100L (80 self + 20 cross-attn image layers,
one cross layer after every 4 self layers) d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256.  [hf:meta-llama/Llama-3.2-90B-Vision]

The vision tower is a stub, as in the reference: a batch carries
precomputed patch embeddings (B, 1024, d_model) as ``image_features``,
projected by a learned img_proj and cross-attended with tanh-gated
residuals (gate init 0).

long_500k: SKIP — full attention.
"""

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=4,
    n_image_tokens=1024,
    rope_theta=500000.0,
    remat_group=2,
    loss_chunks=8,
)

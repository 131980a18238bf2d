"""hubert-xlarge [audio]: encoder-only, 48L d_model=1280 16H (MHA kv=16)
d_ff=5120 vocab=504 (masked-prediction cluster targets).
[arXiv:2106.07447]

The conv waveform frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings ``features`` (B, S, d_model), projected by
``frontend_proj``.  No decode: an encoder has no autoregressive step.
"""

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    norm="layernorm",
    glu=False,
    act="gelu",
    frontend="audio",
    remat_group=2,
)

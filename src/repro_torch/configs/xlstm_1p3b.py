"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, 7:1 ratio (xLSTM[7:1]).
48L d_model=2048 4H d_ff=0 (mLSTM blocks carry their own 2x up-projection;
sLSTM blocks carry a 4/3 gated FFN) vocab=50304.  [arXiv:2405.04517]

long_500k: RUNS — O(1) recurrent state.
"""

from repro_torch.models.common import LMConfig, XLSTMConfig

CONFIG = LMConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0,
                      slstm_ff_factor=1.3333, d_conv=4, chunk_size=256),
    remat_group=1,
)

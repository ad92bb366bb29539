"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]).

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517].
d_ff=0: xLSTM blocks carry their own up/down projections; there is no
separate transformer FFN.  Linear-time recurrence ⇒ long_500k runs.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    layer_pattern=(MLSTM,) * 7 + (SLSTM,),
    xlstm=XLSTMConfig(chunk=256, proj_factor=2.0, slstm_every=8),
    tie_embeddings=False,
)

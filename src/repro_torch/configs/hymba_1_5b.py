"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf].  Hymba uses sliding-window attention on most layers
with a few full-attention layers (first/middle/last per the paper); the
mamba heads run in parallel with the attention heads inside every layer.
Sub-quadratic ⇒ the long_500k cell runs for this arch.
"""
from repro_torch.configs.base import ATTN, HYBRID, ArchConfig, SSMConfig

# Pattern of 8 positions tiled 4x over 32 layers: position 0 is a
# full-attention hybrid layer, positions 1..7 use sliding-window attention
# in the attention half of the hybrid head group.
CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    layer_pattern=(HYBRID + ":full",) + (HYBRID + ":local",) * 7,
    window=1024,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=1),
    rope_theta=10000.0,
)

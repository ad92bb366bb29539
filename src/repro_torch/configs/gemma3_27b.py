"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3 family].  Pattern: five sliding-window layers then one
global layer.  QK-norm, no attention softcap (gemma3 dropped it).
long_500k skipped: global layers are O(L^2).
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, DENSE, ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    layer_pattern=("dense:local",) * 5 + ("dense:full",),
    window=1024,
    qk_norm=True,
    rope_theta=1000000.0,
    act="gelu",
    tie_embeddings=True,
)

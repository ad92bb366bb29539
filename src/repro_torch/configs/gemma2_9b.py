"""gemma2-9b [dense] — alternating local/global attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118].
Attention logit softcap 50.0, final LM logit softcap 30.0, window 4096.
long_500k skipped: global layers are O(L^2).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    layer_pattern=("dense:local", "dense:full"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    act="gelu",
    tie_embeddings=True,
)

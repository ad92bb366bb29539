"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219].
long_500k skipped: pure full attention.
"""
from repro_torch.configs.base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    head_dim=128,
    layer_pattern=(DENSE,),
    rope_theta=10000.0,
    tie_embeddings=False,
)

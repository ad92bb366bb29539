"""llama3.2-3b [dense] — small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B family].  Pure full attention ⇒ long_500k
is skipped (O(L^2)); see DESIGN.md §4.
"""
from repro_torch.configs.base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=128,
    layer_pattern=(DENSE,),
    rope_theta=500000.0,
    tie_embeddings=True,
)

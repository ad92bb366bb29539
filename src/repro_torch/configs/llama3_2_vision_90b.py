"""llama-3.2-vision-90b [vlm] — cross-attention image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-Vision family].  Every 5th layer cross-attends to
precomputed image-patch embeddings (the vision frontend is a STUB:
``input_specs`` supplies (B, n_patches, d_model) embeddings directly, per
the assignment).  long_500k skipped: full attention.
"""
from repro_torch.configs.base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    layer_pattern=(DENSE,) * 4 + ("dense:cross",),
    context_seq=1600,  # image patch tokens (stub frontend)
    rope_theta=500000.0,
    tie_embeddings=False,
)

"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stub.

32L d_model=1280 20H (kv=20, i.e. MHA) d_ff=5120 vocab=51866
[arXiv:2212.04356].  32 encoder layers (bidirectional) + 32 decoder layers
(causal self-attn + cross-attn to encoder states).  The mel-spectrogram conv
frontend is a STUB: ``input_specs`` supplies (B, 1500, d_model) frame
embeddings.  long_500k skipped: decoder is full attention.  The decode shape
lowers the decoder serve_step with self-attn KV cache + precomputed
cross-attn KV.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers; encoder_layers below
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    layer_pattern=("dense:cross",),  # every decoder layer: self + cross
    encoder_layers=32,
    encoder_seq=1500,
    act="gelu",
    tie_embeddings=True,
)

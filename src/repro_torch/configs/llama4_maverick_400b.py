"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, interleaved MoE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4 family].  Maverick interleaves dense and MoE layers
(interleave_moe_layer_step=2); MoE layers have 128 routed experts (top-1)
plus one always-on shared expert, expert d_ff 8192; dense layers use
d_ff_mlp 16384.  Early-fusion multimodal attention is out of scope for the
LM backbone cells (text shapes only).  long_500k skipped: full attention.
"""
from repro_torch.configs.base import DENSE, MOE, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,             # dense-layer FFN width
    vocab=202048,
    head_dim=128,
    layer_pattern=(DENSE, MOE),
    # router_group=4096 (one dispatch group per training sub-batch):
    # scanning smaller groups makes GSPMD all-reduce the accumulated
    # expert-weight gradients once PER GROUP — 4x the necessary collective
    # volume (§Perf hillclimb #2).  One group per sequence keeps dispatched
    # activations small ((B_loc, 8, 160, 5120) bf16 ~130 MB/device) while
    # reducing gradients once per microbatch.
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                  expert_d_ff=8192, shared_expert=True, router_group=4096),
    rope_theta=500000.0,
    tie_embeddings=False,
)

"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base].  Every layer is MoE.
long_500k skipped: full attention.
"""
from repro_torch.configs.base import MOE, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    layer_pattern=(MOE,),
    # router_group=4096: one dispatch group per training sub-batch, so
    # expert-weight gradients reduce once per microbatch instead of once
    # per 1k-token group (§Perf hillclimb #2; same reasoning as llama4).
    moe=MoEConfig(n_experts=16, top_k=4, capacity_factor=1.25,
                  router_group=4096),
    rope_theta=500000.0,
    tie_embeddings=False,
)

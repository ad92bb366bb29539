"""Architecture + shape configuration schema, the port's own copy of
``repro.configs.base`` (pure Python, shared by no import).

Every assigned architecture is expressed as an :class:`ArchConfig`.  The
reference backbone consumes the config's ``layer_pattern`` — a repeating
"superblock" of layer types, stacked on a leading axis — so heterogeneous
stacks (local/global attention, dense/MoE interleave, mLSTM/sLSTM mixes,
self/cross attention) are O(pattern) to describe.  The port's
``models/backbone.py`` builds the same parameter shapes from it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

# Layer-type tags understood by the backbones (models/backbone.py).
ATTN = "attn"              # causal self attention (full)
ATTN_LOCAL = "attn_local"  # causal self attention, sliding window
ATTN_BIDIR = "attn_bidir"  # bidirectional self attention (encoder)
ATTN_CROSS = "attn_cross"  # cross attention to a context sequence
HYBRID = "hybrid"          # parallel attention + mamba heads (hymba)
MLSTM = "mlstm"            # xLSTM matrix-memory block
SLSTM = "slstm"            # xLSTM scalar-memory block
MOE = "moe"                # MoE FFN layer (attn mixer + routed experts)
DENSE = "dense"            # plain attn mixer + dense FFN

RECURRENT_TYPES = (HYBRID, MLSTM, SLSTM)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    expert_d_ff: int = 0          # 0 -> use ArchConfig.d_ff
    shared_expert: bool = False   # llama4-style always-on shared expert
    router_group: int = 1024      # tokens per dispatch group (scanned)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # N, per-channel SSM state
    conv_width: int = 4
    expand: int = 1               # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # mLSTM / sLSTM block geometry (head_dim = d_model / n_heads).
    chunk: int = 256              # chunkwise-parallel chunk length (mLSTM)
    proj_factor: float = 2.0      # mLSTM up-projection factor
    slstm_every: int = 8          # 1 sLSTM per this many layers (7:1 mix)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # Attention pattern.
    layer_pattern: Tuple[str, ...] = (DENSE,)
    window: int = 1024            # sliding window for ATTN_LOCAL layers
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0     # gemma2-style tanh softcap on logits
    final_softcap: float = 0.0    # softcap on LM logits
    qk_norm: bool = False         # gemma3-style rmsnorm on q,k
    tie_embeddings: bool = True
    # Optional sub-configs.
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # Encoder (whisper) / multimodal context (vision) stubs.
    encoder_layers: int = 0       # >0 -> enc-dec model
    encoder_seq: int = 1500       # audio frames after conv stub
    context_seq: int = 0          # >0 -> cross-attn context length (vision)
    # Norm/activation choices.
    norm_eps: float = 1e-6
    act: str = "silu"             # silu -> SwiGLU; gelu -> GeGLU
    # Attention-free model?  (xLSTM has no conventional FFN when d_ff == 0.)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding tables are padded to a multiple of 256 so the vocab
        dimension shards evenly over a 16-way model axis (standard practice;
        hymba's 32001 and whisper's 51866 are not otherwise divisible)."""
        return _round_up(self.vocab, 256)

    @property
    def q_group(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0, self.name
        return self.n_heads // self.n_kv_heads

    def pattern_plan(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(pattern, n_superblocks, remainder_layer_types)."""
        p = self.layer_pattern
        n_super = self.n_layers // len(p)
        rem = tuple(p[: self.n_layers % len(p)])
        return p, n_super, rem

    # ---- analytical parameter / FLOP accounting (for roofline ratios) ----
    def param_count(self) -> int:
        """Exact parameter count of the implemented model (padded vocab)."""
        from repro_torch.models import accounting  # local import to avoid cycle

        return accounting.param_count(self)

    def model_flops_per_token(self, seq_len: int, training: bool) -> float:
        """6*N*D-style useful-FLOPs estimate (MoE: active params only)."""
        from repro_torch.models import accounting

        return accounting.model_flops_per_token(self, seq_len, training)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the layer_pattern (one full superblock + remainder coverage), cuts
    width/heads/vocab/experts to toy sizes.
    """
    pattern = cfg.layer_pattern
    n_layers = min(cfg.n_layers, len(pattern) + 1)  # 1 superblock + 1 rem
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k), router_group=64, expert_d_ff=64)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, state_dim=4)
    xl = cfg.xlstm
    if xl is not None:
        xl = dataclasses.replace(xl, chunk=16, slstm_every=2)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        window=8,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=16 if cfg.encoder_layers else cfg.encoder_seq,
        context_seq=16 if cfg.context_seq else 0,
        moe=moe,
        ssm=ssm,
        xlstm=xl,
    )

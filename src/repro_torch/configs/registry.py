"""Registry of assigned architectures (``--arch <id>``)."""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import base
from repro_torch.configs.base import ArchConfig, ShapeSpec

from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM
from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA32_3B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3_14B
from repro_torch.configs.llama3_2_vision_90b import CONFIG as VISION_90B
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_V3
from repro_torch.configs.dbrx_132b import CONFIG as DBRX
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAV

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        HYMBA, XLSTM, LLAMA32_3B, GEMMA3_27B, GEMMA2_9B,
        PHI3_14B, VISION_90B, WHISPER_V3, DBRX, LLAMA4_MAV,
    )
}

# Architectures whose sequence mixing is sub-quadratic end to end; only
# these run the long_500k cell (see DESIGN.md §4).
SUBQUADRATIC = ("hymba-1.5b", "xlstm-1.3b")


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is (arch x shape) runnable?  Returns (ok, reason_if_skipped)."""
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, "SKIPPED(full-attention: O(L^2) at 512k)"
    return True, ""


def all_cells() -> List[Tuple[ArchConfig, ShapeSpec]]:
    """All 40 (arch x shape) cells, including ones recorded as skipped."""
    return [(cfg, s) for cfg in ARCHS.values() for s in base.ALL_SHAPES]

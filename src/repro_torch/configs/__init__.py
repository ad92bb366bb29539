from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    ArchConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    SHAPES,
    XLSTMConfig,
    reduced,
)
from repro_torch.configs.registry import ARCHS, all_cells, cell_supported, get  # noqa: F401

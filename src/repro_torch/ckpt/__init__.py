"""Checkpointing of training state under the persistence policies."""
from repro_torch.ckpt.manager import CheckpointManager, SaveReport  # noqa: F401
from repro_torch.ckpt.manifest import CheckpointCatalog  # noqa: F401

"""Checkpoints in the reference's on-disk format (``manager``)."""
from repro_torch.checkpoint.manager import (CheckpointCorruptionError,
                                            CheckpointManager)

__all__ = ["CheckpointManager", "CheckpointCorruptionError"]

"""Checkpoint substrate: atomic, keep-k, async, in the reference's layout."""

from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]

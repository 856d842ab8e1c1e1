"""Checkpoints (counterpart of ``repro.checkpoint``): atomic, verified,
async, in the reference's on-disk format."""

from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               CheckpointManager, tree_flatten,
                                               tree_map_leaves, tree_unflatten)

__all__ = ["CheckpointManager", "CheckpointCorruptError", "tree_flatten",
           "tree_unflatten", "tree_map_leaves"]

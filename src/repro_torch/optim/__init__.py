"""Optimizers (counterpart of ``repro.optim``: AdamW and SGD; loss scaling
and gradient compression are not ported yet, see ROADMAP.md)."""

from repro_torch.optim.optimizer import (SGD, AdamW, OptState,
                                        clip_by_global_norm, global_norm,
                                        tree_leaves, tree_map)

__all__ = ["AdamW", "SGD", "OptState", "clip_by_global_norm", "global_norm",
           "tree_leaves", "tree_map"]

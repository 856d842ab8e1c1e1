"""Optimizers (counterpart of ``repro.optim``: AdamW, SGD and FP16 loss
scaling; FP8 delayed scaling and gradient compression are not ported yet,
see ROADMAP.md)."""

from repro_torch.optim.optimizer import (SGD, AdamW, OptState,
                                        clip_by_global_norm, global_norm,
                                        tree_leaves, tree_map)
from repro_torch.optim.scale import (LossScaleState, adjust, init_scale,
                                    scale_loss, unscale_and_check)

__all__ = ["AdamW", "SGD", "OptState", "clip_by_global_norm", "global_norm",
           "tree_leaves", "tree_map", "LossScaleState", "init_scale",
           "scale_loss", "unscale_and_check", "adjust"]

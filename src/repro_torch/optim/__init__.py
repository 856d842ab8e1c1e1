"""Optimizers (counterpart of ``repro.optim``: AdamW, SGD, FP16 loss
scaling, the FP8 delayed-scaling state and the compressed gradient
wire)."""

from repro_torch.optim.compression import (Compressor, Fp8LeafState,
                                           collective_wire_bytes,
                                           compressed_mean_allreduce)
from repro_torch.optim.optimizer import (SGD, AdamW, OptState,
                                        clip_by_global_norm, global_norm,
                                        tree_leaves, tree_map)
from repro_torch.optim.scale import (Fp8ScaleState, LossScaleState, adjust,
                                    fp8_scale_of, init_fp8_scale,
                                    init_fp8_scale_tree, init_scale,
                                    observe_amax, observe_amax_tree, scale_loss,
                                    unscale_and_check, update_fp8_scale)

__all__ = ["AdamW", "SGD", "OptState", "clip_by_global_norm", "global_norm",
           "tree_leaves", "tree_map", "LossScaleState", "init_scale",
           "scale_loss", "unscale_and_check", "adjust", "Fp8ScaleState",
           "init_fp8_scale", "observe_amax", "fp8_scale_of", "update_fp8_scale",
           "init_fp8_scale_tree", "observe_amax_tree", "Compressor",
           "Fp8LeafState", "collective_wire_bytes", "compressed_mean_allreduce"]

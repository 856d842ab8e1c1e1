"""TinyMLPerf deep AutoEncoder — the paper's end-to-end use case (§III-B).

Counterpart of ``repro.models.autoencoder``.  MLPerf Tiny anomaly
detection (ToyADMOS): 640 -> [128 x4] -> 8 -> [128 x4] -> 640, trained
with MSE.  Every layer is an :func:`repro_torch.core.engine.linear` with a
bias, so under ``paper_fp16`` each runs the RedMulE GEMM with its fp16
accumulator, and its backward the fused dW pass that also returns the bias
gradient.  Hidden layers are Dense -> BatchNorm (batch statistics in fp32,
biased variance) -> ReLU, as in the MLPerf Tiny reference model.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.models.layers import Param, init_tree

__all__ = ["ae_schema", "init_ae", "ae_forward", "ae_loss", "AE_DIMS"]

# the reference's repro.core.perf_model.AE_DIMS
AE_DIMS: Tuple[int, ...] = (640, 128, 128, 128, 128, 8, 128, 128, 128, 128, 640)


def ae_schema() -> Dict[str, Any]:
    """``fc{i}``: ``w (d_in, d_out)`` (He init), ``b``, and for every
    hidden layer the BatchNorm ``gamma`` / ``beta``."""
    s: Dict[str, Any] = {}
    n = len(AE_DIMS) - 1
    for i in range(n):
        s[f"fc{i}"] = {"w": Param((AE_DIMS[i], AE_DIMS[i + 1]),
                                   ("ae_hidden", "ae_hidden"), init="he"),
                       "b": Param((AE_DIMS[i + 1],), ("ae_hidden",), init="zeros")}
        if i != n - 1:
            s[f"fc{i}"]["gamma"] = Param((AE_DIMS[i + 1],), ("ae_hidden",), init="ones")
            s[f"fc{i}"]["beta"] = Param((AE_DIMS[i + 1],), ("ae_hidden",), init="zeros")
    return s


def init_ae(*, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """fp32 parameters drawn per path from ``torch.Generator`` seeds (not
    the reference's numbers; :func:`repro_torch.convert.ae_params_from_jax`
    carries those across)."""
    return init_tree(ae_schema(), seed=seed, device=torch.device(device),
                     dtype=torch.float32)


def ae_forward(params, x: torch.Tensor, *,
               policy: prec.Policy = prec.PAPER_FP16,
               backend=None, stats_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """``x (B, 640)`` -> reconstruction ``(B, 640)`` in the policy's
    output dtype.

    ``stats_dtype`` is the dtype BatchNorm computes in: fp32 as the
    reference does.  float64 makes its reductions over the batch (forward
    statistics and their backward sums) independent of the summation
    order, so two devices can be compared without BatchNorm's
    ill-conditioning."""
    h = x
    n = len(AE_DIMS) - 1
    for i in range(n):
        p = params[f"fc{i}"]
        h = engine.linear(h, p["w"], p["b"], policy=policy, backend=backend)
        if i != n - 1:
            hf = h.to(stats_dtype)
            mu = hf.mean(dim=0, keepdim=True)
            var = hf.var(dim=0, keepdim=True, unbiased=False)
            hf = (hf - mu) * torch.rsqrt(var + 1e-5)
            hf = hf * p["gamma"].to(stats_dtype) + p["beta"].to(stats_dtype)
            h = torch.relu(hf).to(h.dtype)
    return h


def ae_loss(params, x: torch.Tensor, *, policy: prec.Policy = prec.PAPER_FP16,
            backend=None, stats_dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reconstruction MSE in fp32, and ``{"mse": loss}``."""
    rec = ae_forward(params, x, policy=policy, backend=backend,
                     stats_dtype=stats_dtype)
    err = rec.float() - x.float()
    loss = torch.mean(err * err)
    return loss, {"mse": loss}

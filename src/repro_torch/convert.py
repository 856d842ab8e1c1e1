"""Carry the JAX package's parameters across to the port.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so the tests that hold the port against ``repro`` initialise the
reference's parameters and hand the same values to both packages.  The
reference's tree arrives as numpy arrays (``jax.device_get`` of
``repro.models.transformer.init_params``), with stacked leading layer dims;
the port keeps that structure and layout, so the conversion is a checked
copy.  The AutoEncoder's tree (``fc{i}.{w,b,gamma,beta}``) converts the same
way (:func:`ae_params_from_jax`), and a decode cache — FP8 codes and their
``*_scale`` leaves included — bit for bit (:func:`cache_from_jax`), so both
packages can start from one pool.  This module imports neither JAX nor
``repro``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import autoencoder, transformer
from repro_torch.models.layers import Param

__all__ = ["params_from_jax", "ae_params_from_jax", "cache_from_jax"]


def params_from_jax(tree: Dict[str, Any], cfg, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The port's parameters from the reference's numpy tree.

    Every leaf of the port's schema must be present with the same shape;
    values are cast to ``dtype`` (the policy's compute dtype by default —
    see :func:`repro_torch.models.transformer.init_params` for why that
    computes the same as fp32 weights)."""
    return _convert(transformer.schema(cfg), tree, resolve_device(device),
                    dtype or cfg.policy.compute_dtype)


def ae_params_from_jax(tree: Dict[str, Any], device="cuda",
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The port's AutoEncoder parameters from the reference's numpy tree
    (``repro.models.autoencoder.init_ae``): fp32 master weights, as the
    reference trains them."""
    return _convert(autoencoder.ae_schema(), tree, resolve_device(device),
                    dtype)


def _convert(schema: Dict[str, Any], tree: Dict[str, Any],
             dev: torch.device, dt: torch.dtype) -> Dict[str, Any]:
    def go(node, src, path):
        if isinstance(node, Param):
            a = np.array(src, dtype=np.float32)   # a writable copy
            if a.shape != tuple(node.shape):
                raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                                 f"expected {tuple(node.shape)}")
            return torch.from_numpy(a).to(device=dev, dtype=dt)
        missing = set(node) - set(src)
        if missing:
            raise KeyError(f"{'/'.join(path) or '<root>'}: missing {sorted(missing)}")
        return {k: go(v, src[k], path + (k,)) for k, v in node.items()}

    return go(schema, tree, ())


# numpy dtype name -> (the integer view carrying its bits, the torch dtype);
# bfloat16 and the FP8 formats arrive as ml_dtypes arrays
_BITS = {"bfloat16": (np.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def cache_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's decode cache from the reference's (numpy leaves, the same
    nested dict): every leaf copied bit for bit in its own dtype."""
    dev = resolve_device(device)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.name in _BITS:
            view, dt = _BITS[a.dtype.name]
            return torch.from_numpy(a.view(view).copy()).view(dt).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return go(tree)

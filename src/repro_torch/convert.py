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
packages can start from one pool.  A training state (``TrainState``:
parameters, AdamW moments and step, loss scale) converts with
:func:`train_state_from_jax`, a gradient wire's per-leaf compressor state
(``Fp8LeafState`` trees, with or without the host axis) with
:func:`compressor_state_from_jax`, both bit for bit, so both packages can
train on from one state.  This module imports neither JAX nor ``repro``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import autoencoder, transformer
from repro_torch.models.layers import Param
from repro_torch.optim import Fp8LeafState, Fp8ScaleState, LossScaleState, OptState

__all__ = ["params_from_jax", "ae_params_from_jax", "cache_from_jax",
           "train_state_from_jax", "compressor_state_from_jax"]


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


def _exact(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def train_state_from_jax(state, cfg, device="cuda"):
    """The port's ``launch.train.TrainState`` from the reference's (numpy
    leaves): fp32 master parameters that take gradients, the AdamW
    moments, the step as an int, and the loss scale (``()`` when off),
    every value bit for bit."""
    from repro_torch.launch.train import TrainState

    dev = resolve_device(device)
    schema = transformer.schema(cfg)
    dt = getattr(torch, cfg.param_dtype)
    params = _convert(schema, state.params, dev, dt)
    for p in _tensors(params):
        p.requires_grad_(True)
    opt = state.opt
    moments = [None if m is None else _convert(schema, m, dev, torch.float32)
               for m in (opt.mu, opt.nu)]
    scale = state.scale
    if isinstance(scale, tuple) and len(scale):
        scale = LossScaleState(*(_exact(x, dev) for x in scale))
    return TrainState(params=params, opt=OptState(int(np.asarray(opt.step)), *moments),
                      scale=scale)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def compressor_state_from_jax(tree, device="cuda"):
    """The port's compressor state from the reference's (numpy leaves): a
    dict tree of fp32 error-feedback arrays, or of ``Fp8LeafState``
    (residual and delayed-scale window), leading host axis kept if
    present; None passes through."""
    dev = resolve_device(device)

    def go(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, tuple) and getattr(node, "_fields", None) == Fp8LeafState._fields:
            return Fp8LeafState(ef=_exact(node.ef, dev),
                                scale=Fp8ScaleState(*(_exact(x, dev) for x in node.scale)))
        return _exact(node, dev)

    return go(tree)

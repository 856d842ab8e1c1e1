"""One source of truth for decode-cache sharding specs.

Counterpart of ``repro.serving.specs``: ``launch/serve.py``
(``cache_spec_tree``) routes through :func:`decode_cache_specs`, so the
cache's abstract shapes and its specs cannot drift apart.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models import transformer
from repro_torch.runtime import sharding

__all__ = ["decode_cache_specs"]


def _map(fn, axes, abstract):
    if isinstance(axes, tuple):
        return fn(axes, abstract)
    return {k: _map(fn, axes[k], abstract[k]) for k in axes}


def decode_cache_specs(cfg, rules, mesh, batch: int, max_len: int, *,
                       dtype=None, storage_dtype: Optional[str] = None) -> Tuple:
    """(abstract cache tree of meta tensors, sanitized spec tree) for
    decode; ``storage_dtype`` grows the FP8 cache's per-head scale leaves
    in both trees.  Reads only ``mesh.shape``."""
    axes = transformer.cache_axes(cfg, storage_dtype)
    from repro_torch.roofline.memory import described

    with sharding.use_mesh(None), described():      # the global cache, described
        abstract = transformer.init_cache(cfg, batch, max_len, dtype=dtype,
                                          storage_dtype=storage_dtype,
                                          device="meta")
    spec = _map(lambda ax, a: sharding.sanitize_spec(
        sharding.logical_spec(ax, rules), tuple(a.shape), mesh), axes, abstract)
    return abstract, spec

"""A checkpoint for the ranks of a data-parallel group whose state holds
a per-rank part (the compressed wire's error feedback and scales): rank 0
writes one logical checkpoint with that part stacked on a leading host
axis, the layout of the reference's per-host state, and each rank
restores its own slot.  Used by ``launch.train``'s data-parallel loop and
``runtime.elastic``'s worker."""

from __future__ import annotations

import hashlib
import time

import numpy as np

from repro_torch.checkpoint.checkpoint import (CheckpointManager, _to_numpy,
                                               tree_flatten, tree_map_leaves)
from repro_torch.runtime import procs

__all__ = ["HostAxisCheckpoint", "digest", "with_part", "stacked_like"]


def digest(tree) -> str:
    """Order-stable sha256 over the bytes of every leaf, in the
    checkpoint's (``jax.tree``'s) order."""
    h = hashlib.sha256()
    for leaf in tree_flatten(tree):
        h.update(np.ascontiguousarray(_to_numpy(leaf)).reshape(-1).view(np.uint8))
    return h.hexdigest()


def with_part(state, key, value):
    """``state`` (a dict, tuple or NamedTuple) with ``state[key]`` replaced."""
    if isinstance(state, dict):
        return {**state, key: value}
    out = list(state)
    out[key] = value
    return type(state)(*out) if hasattr(state, "_fields") else tuple(out)


def stacked_like(part, n: int):
    """``part``'s leaves with a leading host axis of ``n`` (shapes only)."""
    return tree_map_leaves(lambda x: x.expand(n, *x.shape), part)


class HostAxisCheckpoint:
    """A :class:`CheckpointManager` for the ranks of a data-parallel group
    whose state holds a per-rank part at ``state[key]`` (a tuple index or
    a dict key; None on the fp32 wire).

    ``save`` gathers every rank's part to rank 0 (a collective: every rank
    calls it) and rank 0 writes one checkpoint with the part's leaves
    stacked on a leading host axis; ``restore_latest`` reads it on every
    rank and keeps this rank's slot.  ``save_s`` / ``restore_s`` record the
    seconds each took on this rank."""

    def __init__(self, ckpt: CheckpointManager, key):
        self.ckpt, self.key = ckpt, key
        self.root = ckpt.root
        self.save_s, self.restore_s = [], []

    def _dir(self, step: int) -> str:
        return self.ckpt._dir(step)

    def wait(self) -> None:
        self.ckpt.wait()

    def global_state(self, state):
        """The state with its per-rank part stacked over the ranks (host
        arrays) on rank 0; None on the other ranks.  A collective."""
        part = state[self.key]
        stacked = None if part is None else tree_map_leaves(procs.gather_to_rank0, part)
        return with_part(state, self.key, stacked) if procs.rank() == 0 else None

    def save(self, step: int, state, metadata=None) -> None:
        t0 = time.perf_counter()
        g = self.global_state(state)
        if g is not None:
            self.ckpt.save(step, g, metadata)
        self.save_s.append(time.perf_counter() - t0)

    def save_async(self, step: int, state, metadata=None) -> None:
        t0 = time.perf_counter()
        g = self.global_state(state)
        if g is not None:
            self.ckpt.save_async(step, g, metadata)
        self.save_s.append(time.perf_counter() - t0)

    def restore_latest(self, like, *, log=None):
        t0 = time.perf_counter()
        part = like[self.key]
        like_g = like if part is None else with_part(
            like, self.key, stacked_like(part, procs.world()))
        got = self.ckpt.restore_latest(like_g, log=log)
        if got is None:
            return None
        step, tree, meta = got
        if part is not None:
            r = procs.rank()
            tree = with_part(tree, self.key, tree_map_leaves(
                lambda x: x[r].clone(), tree[self.key]))
        self.restore_s.append(time.perf_counter() - t0)
        return step, tree, meta

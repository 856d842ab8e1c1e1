"""Atomic, async, *verified* checkpointing.

Counterpart of ``repro.checkpoint.checkpoint`` (``checkpoint.py:52-214``),
with its on-disk format::

    <root>/step_000123.tmp/...   (while writing)
    <root>/step_000123/
        manifest.json            tree structure, shapes, dtypes, per-leaf
                                 crc32 checksums, metadata
        arrays.npz               the flattened leaves, ``leaf_{i}``

The leaves are numbered in ``jax.tree``'s order (:func:`tree_flatten`:
dict keys sorted, NamedTuple and tuple fields in order, ``None`` and ``()``
holding no leaf, a Python int as a 0-d int32 array), so ``leaf_i`` is the
same tensor in both packages and either reads the other's checkpoint.

* **atomic** — written to ``.tmp`` then ``os.replace``d: ``latest()`` only
  sees complete directories;
* **verified** — the manifest carries a crc32 per leaf, taken from the
  bytes that went into ``arrays.npz``; ``restore`` recomputes them and a
  mismatch, a truncated or undecodable payload or a missing leaf raises
  :class:`CheckpointCorruptError`;
* **self-healing** — ``restore_latest`` walks the steps newest first and
  skips a corrupt one with a warning; a structural mismatch against the
  restore target stays a ``ValueError`` (the caller changed, not the disk);
* **async** — ``save_async`` copies every leaf to host memory before it
  returns (the port's train step updates its tensors in place) and writes
  on a thread;
* **logical** — ``restore`` returns host tensors in the structure of its
  target; the caller places them (``runtime.fault_tolerance.reshard``);
* **bounded** — the ``keep`` most recent checkpoints are retained.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
import zipfile
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "CheckpointCorruptError", "tree_flatten",
           "tree_unflatten", "tree_map_leaves"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists but its payload cannot be trusted:
    truncated or undecodable arrays, a missing leaf, or a checksum
    mismatch.  ``restore_latest`` falls back past this error, and only
    this one."""


# ------------------------------------------------------------------ #
# Trees in jax.tree's order
# ------------------------------------------------------------------ #
def tree_flatten(tree) -> List[Any]:
    """The leaves of a tree of dicts, NamedTuples, tuples and lists in
    ``jax.tree.flatten``'s order: dict keys sorted, sequence fields in
    order, ``None`` holding no leaf.  Anything else is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """Put ``leaves`` (in :func:`tree_flatten`'s order) into the structure
    of ``like``; dicts keep ``like``'s key order."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def _rebuild(like, it: Iterator):
    if like is None:
        return None
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, it) for v in like)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the structure holds")
    return leaf


def tree_map_leaves(fn: Callable, tree) -> Any:
    """``fn`` over every leaf, the structure kept."""
    return tree_unflatten(tree, [fn(x) for x in tree_flatten(tree)])


def _describe(tree) -> str:
    """The structure as text, leaves as ``*`` (the manifest's
    ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def _to_numpy(x, copy: bool = False) -> np.ndarray:
    """A leaf as a host array: a tensor's values (a copy when ``copy``, or
    when it lives on a device), a Python int as int32, a float as fp32."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.copy() if copy and x.device.type == "cpu" else a
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x, np.bool_)
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if isinstance(x, float):
        return np.asarray(x, np.float32)
    a = np.asarray(x)
    return a.copy() if copy else a


def _crc(arr: np.ndarray) -> int:
    """crc32 of the array's C-order bytes (the reference's
    ``zlib.crc32(arr.tobytes())``, without the copy)."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return zlib.crc32(flat.view(np.uint8)) & 0xFFFFFFFF


def _from_numpy(arr: np.ndarray, like):
    """A restored array as the target leaf's kind: a Python int or float
    for a Python scalar target, else a host tensor."""
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- #
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- #
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> str:
        """Synchronous atomic save, with per-leaf checksums."""
        arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(tree_flatten(tree))}
        final = self._dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "treedef": _describe(tree),
            "n_leaves": len(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "checksums": {k: _crc(v) for k, v in arrays.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def save_async(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> None:
        """Copy every leaf to host memory now, write in the background."""
        self.wait()  # one in flight at a time
        snapshot = tree_map_leaves(lambda x: _to_numpy(x, copy=True), tree)

        def run():
            try:
                self.save(step, snapshot, metadata)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------- #
    def _load_verified(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Read and checksum-verify one checkpoint's payload; anything
        untrustworthy on disk raises :class:`CheckpointCorruptError`."""
        d = self._dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            arrays: Dict[str, np.ndarray] = {}
            with np.load(os.path.join(d, "arrays.npz")) as data:
                for i in range(manifest["n_leaves"]):
                    arrays[f"leaf_{i}"] = data[f"leaf_{i}"]
        except (OSError, EOFError, KeyError, ValueError,
                zipfile.BadZipFile, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} at {d} is unreadable "
                f"({type(e).__name__}: {e})") from e
        checksums = manifest.get("checksums")
        if checksums:
            for k, arr in arrays.items():
                want = checksums.get(k)
                got = _crc(arr)
                if want is not None and got != want:
                    raise CheckpointCorruptError(
                        f"checkpoint step {step}: checksum mismatch on {k} "
                        f"(manifest {want}, disk {got})")
        return arrays, manifest

    def restore(self, step: int, like: Any) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` as host tensors (Python
        scalars where ``like`` holds one); the payload is verified."""
        arrays, manifest = self._load_verified(step)
        leaves = tree_flatten(like)
        if len(leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"restore target has {len(leaves)}")
        out = []
        for i, leaf in enumerate(leaves):
            arr = arrays[f"leaf_{i}"]
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf_{i}: checkpoint {arr.shape} vs target {want}")
            out.append(_from_numpy(arr, leaf))
        return tree_unflatten(like, out), manifest["metadata"]

    def restore_latest(
        self, like: Any, *, log: Optional[Callable[[str], None]] = None,
    ) -> Optional[Tuple[int, Any, Dict]]:
        """Restore the newest *valid* checkpoint, skipping corrupt or
        truncated ones with a warning each; None when none is valid.
        Structural mismatches against ``like`` still raise."""
        emit = log if log is not None else (
            lambda msg: print(msg, file=sys.stderr))
        for step in reversed(self.all_steps()):
            try:
                tree, meta = self.restore(step, like)
                return step, tree, meta
            except CheckpointCorruptError as e:
                emit(f"[ckpt] WARNING: skipping corrupt checkpoint "
                     f"step {step}: {e}")
        return None

    # ------------------------------------------------------------- #
    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

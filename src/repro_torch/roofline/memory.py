"""Device memory of a traced step, as the card's caching allocator would
hold it, and the aten ops the step runs.

The dry run (``launch/dryrun.py``) runs one rank's program on meta
tensors: shapes and dtypes, no storage.  :class:`MemoryTracker` is the
``TorchDispatchMode`` it runs under.  Every aten op passes through it, so
it sees every storage the step allocates, in the thread of the step and
in the backward's:

* a result whose storage is new is an allocation of its size rounded up
  to the caching allocator's 512-byte blocks; a weak-reference finalizer
  on the storage frees it when the last tensor on it dies.  A result that
  shares an operand's storage (a view, an in-place op) allocates nothing;
* :meth:`MemoryTracker.arguments` marks the storages live at the step's
  entry (parameters, optimizer state, cache);
* a meta tensor made to describe shapes (``layers.abstract_tree``, the
  whole-cache description a local cache is cut from) is no allocation on
  the card: the code that makes one does so inside :func:`described`,
  which the tracker does not count.

So ``peak`` is the most bytes live at once, the quantity
``torch.cuda.max_memory_allocated()`` reads on the card, and the summary
(:meth:`MemoryTracker.summary`) is the reference's ``memory_analysis``
over it: ``argument_bytes`` (live at entry), ``temp_bytes`` (peak less
arguments), ``output_bytes`` (the results' storages) and ``alias_bytes``
(results that are arguments' storages: the state updated in place).

Beside the memory, each op's flops and bytes are summed by the rules of
:func:`repro_torch.roofline.analysis.aten_costs` (``ops``), for the
roofline's structural half.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["MemoryTracker", "BLOCK", "rounded", "tree_bytes", "described"]

BLOCK = 512     # the caching allocator's block: every allocation rounds up to it

_local = threading.local()


@contextlib.contextmanager
def described():
    """Meta tensors made in the context describe shapes (a spec tree's
    abstract leaves): no :class:`MemoryTracker` counts them."""
    prev = getattr(_local, "described", False)
    _local.described = True
    try:
        yield
    finally:
        _local.described = prev


def rounded(nbytes: int) -> int:
    """Bytes the caching allocator hands out for a request of ``nbytes``."""
    return 0 if nbytes <= 0 else -(-nbytes // BLOCK) * BLOCK


def _tensors(tree) -> Iterator[torch.Tensor]:
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            yield t


def _operands(args, kwargs) -> list:
    """The tensors among an aten op's arguments (flat, or in one list)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(b for b in a if isinstance(b, torch.Tensor))
    return out


class MemoryTracker(TorchDispatchMode):
    """Live and peak bytes of the storages a step allocates, and the aten
    ops it runs (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Tuple[weakref.ref, int]] = {}
        self._args: Dict[int, weakref.ref] = {}
        self.argument_bytes = 0
        # op name -> [calls, flops, bytes]
        self.ops: Dict[str, list] = {}

    # ---- storages ---------------------------------------------------- #
    def _known(self, s) -> bool:
        hit = self._storages.get(id(s))
        return hit is not None and hit[0]() is s

    def _track(self, s) -> int:
        """Count storage ``s`` once; its bytes, 0 if already counted."""
        if self._known(s):
            return 0
        n = rounded(s.nbytes())
        key = id(s)
        self._storages[key] = (weakref.ref(s), n)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key, n)
        return n

    def _free(self, key: int, n: int) -> None:
        hit = self._storages.get(key)
        if hit is not None and hit[0]() is None:
            del self._storages[key]
        self.live -= n

    def arguments(self, *trees) -> int:
        """Mark the storages of ``trees`` live at the step's entry; returns
        their bytes (added to ``argument_bytes``)."""
        n = 0
        for t in _tensors(trees):
            s = t.untyped_storage()
            n += self._track(s)
            self._args[id(s)] = weakref.ref(s)
        self.argument_bytes += n
        return n

    def summary(self, outputs) -> Dict[str, int]:
        """The reference's ``memory_analysis`` fields for a step that
        returned ``outputs``, and its ``peak_bytes``."""
        seen, out_b, alias_b = set(), 0, 0
        for t in _tensors(outputs):
            s = t.untyped_storage()
            if id(s) in seen:
                continue
            seen.add(id(s))
            n = rounded(s.nbytes())
            out_b += n
            ref = self._args.get(id(s))
            if ref is not None and ref() is s:
                alias_b += n
        return {"argument_bytes": self.argument_bytes, "output_bytes": out_b,
                "temp_bytes": self.peak - self.argument_bytes,
                "alias_bytes": alias_b, "peak_bytes": self.peak}

    # ---- dispatch ---------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.roofline.analysis import aten_costs

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_local, "described", False):
            return out
        ins = _operands(args, kwargs)
        mine = {id(t.untyped_storage()) for t in ins}
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                if id(s) not in mine:
                    self._track(s)
        flops, nbytes = aten_costs(func, args, kwargs, out, ins)
        name = func.overloadpacket.__name__
        rec = self.ops.get(name)
        if rec is None:
            rec = self.ops[name] = [0, 0, 0]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out

    def __repr__(self) -> str:
        return (f"MemoryTracker(live={self.live}, peak={self.peak}, "
                f"args={self.argument_bytes})")


def tree_bytes(tree: Any) -> int:
    """The bytes of a tree's tensors (no rounding): a resident state."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))

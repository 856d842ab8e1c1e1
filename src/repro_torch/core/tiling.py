"""Tile shapes for the Hopper kernels.

Counterpart of ``repro.core.tiling``, whose rule sized tiles for a TPU:
an 8 MiB VMEM budget and 128-lane MXU alignment (``tiling.py:29-33``).  On
an H100 a block has at most 227 KB of shared memory, registers are the
scarcer resource, and enough blocks must be in flight to fill 132 SMs, so
tiles are small and come from the fixed menu the CUDA kernel is compiled
for (``csrc/redmule_matmul.cu``):

* ``(bm 64, bn 32, bk 64)`` — the general tile, four warps of 32 x 32;
* ``(bm 16, bn 32, bk 128)`` — small M (decode: a few slots), so the
  weight, which bounds these GEMMs, is read once for the whole batch.

``bn`` is the reduction step.  Every menu entry fits the shared-memory
budget (checked at import).  The flash-attention kernel's tiles are fixed:
64 query rows by 32 KV rows (``FLASH_BQ`` / ``FLASH_BKV``).

Under an fp16 accumulator (``paper_fp16``, ``mixed_fp8_e4m3``) the
reference's reduction block is numerics, not a speed knob: its accumulator
is re-rounded after every ``bn`` rows of the reduction, and ``bn`` depends
on the operands' storage widths.  :func:`accum_block`
is the reference's own tile heuristic (``repro/core/tiling.py:102-175``,
its 8 MiB VMEM budget and 128-lane alignment included), copied so that
the CUDA kernel rounds at the same points whatever its own 32-deep smem
step.  The reference's autotune cache (read only when
``REPRO_AUTOTUNE_CACHE`` is set) is not consulted.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

__all__ = ["TileConfig", "choose_tiles", "smem_bytes", "GEMM_TILES",
           "SMEM_BUDGET", "FLASH_BQ", "FLASH_BKV", "accum_block"]

# shared memory one block may use on Hopper (232,448 bytes)
SMEM_BUDGET = 227 * 1024
FLASH_BQ = 64
FLASH_BKV = 32


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Block shape for Z = X @ W with X (M, N), W (N, K) [paper naming]:
    ``bm`` tiles M, ``bk`` tiles K (output columns), ``bn`` the reduction."""

    bm: int = 64
    bn: int = 32
    bk: int = 64

    def __post_init__(self):
        for name in ("bm", "bn", "bk"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")


# the kernel's compiled tiles, in the order of its `tile` argument
GEMM_TILES = (TileConfig(bm=64, bn=32, bk=64), TileConfig(bm=16, bn=32, bk=128))


def smem_bytes(t: TileConfig, compute_dtype=torch.bfloat16) -> int:
    """Shared memory of one block: padded X and W tiles in the compute
    dtype plus the fp32 output staging tile (csrc/redmule_matmul.cu)."""
    cb = compute_dtype.itemsize
    return (t.bm * (t.bn + 8) + t.bn * (t.bk + 8)) * cb + t.bm * (t.bk + 4) * 4


for _t in GEMM_TILES:
    assert smem_bytes(_t) <= SMEM_BUDGET, _t


def choose_tiles(M: int, N: int, K: int) -> TileConfig:
    """Pick the GEMM tile: the small-M tile when every output row fits one
    16-row tile (each weight element is then read once), else 64 x 64."""
    del N, K  # the menu is fixed (see the module docstring)
    return GEMM_TILES[1] if M <= 16 else GEMM_TILES[0]


# --------------------------------------------------------------------- #
# The reference's reduction block (faithful accumulation)
# --------------------------------------------------------------------- #
# the reference's VMEM budget and its 128-lane tile alignment
MXU_LANE = 128
DEFAULT_VMEM_BUDGET = 8 * 1024 * 1024


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else \
        getattr(torch, str(dtype)).itemsize


def sublane(dtype) -> int:
    """The reference's minimum sublane multiple for a dtype."""
    return max(8, 32 // max(1, _itemsize(dtype)))


def vmem_bytes(t: TileConfig, compute_dtype, accum_dtype, depth: int = 2,
               fused_bwd: bool = False, x_dtype=None, w_dtype=None) -> int:
    """The reference's VMEM working set of one tile (``tiling.py:73-97``):
    ``depth``-buffered X, W (and, for a fused backward, derivative) tiles,
    the resident accumulator, the output tile and the db row.  X and W are
    held at their storage width (``x_dtype`` / ``w_dtype``, None: the
    compute dtype): an FP8 operand's tiles take half the VMEM of fp16 ones,
    since the reference DMAs them narrow and widens on load."""
    cb, ab = _itemsize(compute_dtype), _itemsize(accum_dtype)
    xb = cb if x_dtype is None else _itemsize(x_dtype)
    wb = cb if w_dtype is None else _itemsize(w_dtype)
    d_tile = max(t.bm * t.bn, t.bn * t.bk) * cb if fused_bwd else 0
    db_row = t.bk * ab if fused_bwd else 0
    return (depth * (t.bm * t.bn * xb + t.bn * t.bk * wb + d_tile)
            + t.bm * t.bk * ab + t.bm * t.bk * cb + db_row)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=4096)
def _reference_tiles_cached(M: int, N: int, K: int, compute: str, accum: str,
                            fused_bwd: bool, x_dtype: Optional[str],
                            w_dtype: Optional[str]) -> Tuple[int, int, int]:
    sl = sublane(compute)
    bm = _round_up(min(M, 512), sl)
    bk = _round_up(min(K, 512), MXU_LANE)
    bn = _round_up(min(N, 2048), MXU_LANE)
    while vmem_bytes(TileConfig(bm, bn, bk), compute, accum,
                     fused_bwd=fused_bwd, x_dtype=x_dtype,
                     w_dtype=w_dtype) > DEFAULT_VMEM_BUDGET:
        if bn > MXU_LANE:
            bn //= 2
        elif bk > MXU_LANE:
            bk //= 2
        elif bm > sl:
            bm //= 2
        else:
            break
    return (max(sl, _round_up(bm, sl)), max(MXU_LANE, _round_up(bn, MXU_LANE)),
            max(MXU_LANE, _round_up(bk, MXU_LANE)))


def _name(d) -> Optional[str]:
    return None if d is None else str(d).removeprefix("torch.")


def reference_tiles(M: int, N: int, K: int, *, compute_dtype, accum_dtype,
                    fused_bwd: bool = False, x_dtype=None,
                    w_dtype=None) -> TileConfig:
    """The tile the reference's ``choose_tiles`` picks for this GEMM (its
    ``_choose_tiles_cached``): start from the problem, capped at 512 x 2048
    x 512 and aligned, and halve bn, then bk, then bm until the working set
    fits 8 MiB.  ``x_dtype`` / ``w_dtype`` are the operands' storage dtypes
    (None: the compute dtype); empty dims count as 1, as there."""
    bm, bn, bk = _reference_tiles_cached(
        max(int(M), 1), max(int(N), 1), max(int(K), 1), _name(compute_dtype),
        _name(accum_dtype), bool(fused_bwd), _name(x_dtype), _name(w_dtype))
    return TileConfig(bm=bm, bn=bn, bk=bk)


def accum_block(M: int, N: int, K: int, *, compute_dtype, accum_dtype,
                fused_bwd: bool = False, x_dtype=None, w_dtype=None) -> int:
    """The reduction block after which the reference re-rounds a faithful
    accumulator: its ``tile.bn`` for this dispatch (always a multiple of
    128, so of the CUDA kernel's 32-deep step).  FP8 storage halves the
    streamed tiles, which can double ``bn``: at (512, 4096, 512) fp16
    operands give 1024, E4M3 ones 2048."""
    return reference_tiles(M, N, K, compute_dtype=compute_dtype,
                           accum_dtype=accum_dtype, fused_bwd=fused_bwd,
                           x_dtype=x_dtype, w_dtype=w_dtype).bn

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

A GEMM with few output tiles leaves most of the 132 SMs idle (qwen3-1.7b's
decode projections give 16-96 tiles, the fp32 mLSTM gates 16), so the
kernel splits the reduction inside one launch: :func:`split_plan` gives
the number of slices S and their depth from the shapes alone (no flag, no
environment variable), aiming for about two waves of blocks.  Each slice is
a multiple of the route's step (32 on the tensor cores, 16 on the fp32
route); under a faithful accumulator no slice straddles a rounding block;
a launch with the fused backward (deriv / db) is never split.  The plan
reads no storage dtype, so an FP8 launch and its pre-widened fp16 twin
split alike.

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
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["TileConfig", "choose_tiles", "smem_bytes", "GEMM_TILES",
           "SMEM_BUDGET", "FLASH_BQ", "FLASH_BKV", "accum_block",
           "SplitPlan", "split_plan", "SPLIT_STEP"]

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


# the tensor-core kernel's copy ring (csrc/redmule_matmul.cu, kStages /
# kSlab): stages of 64 reduction rows, two 32-deep (bn) steps each
GEMM_STAGES = 3
GEMM_SLAB = 64


def smem_bytes(t: TileConfig, compute_dtype=torch.bfloat16) -> int:
    """Shared memory of one block of the tensor-core kernel on operands
    stored in the compute dtype (csrc/redmule_matmul.cu, ``GemmSmem``): the
    ring of X and W slabs (room for either orientation, 16 bytes of padding
    a row) and the row-major compute tiles; the fp32 output staging tile
    reuses the ring."""
    cb = compute_dtype.itemsize
    pad = 16 // cb

    def r128(n):
        return -(-n // 128) * 128

    S = GEMM_SLAB
    x_stage = r128(max(t.bm * (S + pad), S * (t.bm + pad)) * cb)
    w_stage = r128(max(S * (t.bk + pad), t.bk * (S + pad)) * cb)
    ring = max(GEMM_STAGES * (x_stage + w_stage), t.bm * (t.bk + 4) * 4)
    return (ring + r128(max(t.bm * (S + 8), S * (t.bm + 8)) * cb)
            + r128(max(S * (t.bk + 8), t.bk * (S + 8)) * cb))


for _t in GEMM_TILES:
    assert smem_bytes(_t) <= SMEM_BUDGET, _t


def choose_tiles(M: int, N: int, K: int) -> TileConfig:
    """Pick the GEMM tile: the small-M tile when every output row fits one
    16-row tile (each weight element is then read once), else 64 x 64."""
    del N, K  # the menu is fixed (see the module docstring)
    return GEMM_TILES[1] if M <= 16 else GEMM_TILES[0]


# --------------------------------------------------------------------- #
# The split of the reduction (csrc/redmule_matmul.cu, `Split`)
# --------------------------------------------------------------------- #
NUM_SMS = 132               # H100 SXM
SPLIT_TARGET = 2 * NUM_SMS  # blocks to aim for: about two waves
MAX_SPLITS = 32
MIN_SPLIT_STEPS = 4         # the shallowest slice, in steps
# the reduction step of each route: the tensor-core kernel's smem slab, the
# fp32 (SIMT) kernel's
SPLIT_STEP = {"tensor": 32, "simt": 16}


class SplitPlan(NamedTuple):
    """``splits`` slices of ``depth`` reduction rows (the last holds the
    rest); unsplit, one slice of all ``N`` rows."""

    splits: int
    depth: int


def split_plan(M: int, N: int, K: int, *, tile: TileConfig, batch: int = 1,
               accum_block: int = 0, route: str = "tensor",
               fused_bwd: bool = False) -> SplitPlan:
    """How many slices the kernel cuts the reduction of one launch into.

    Unsplit when the launch already fills the card (at least one output
    tile per SM), when the reduction is shallower than two slices of
    ``MIN_SPLIT_STEPS`` steps, or with the fused backward (``fused_bwd``:
    db is summed by the first M-tile row without atomics).  Otherwise
    about ``SPLIT_TARGET`` blocks, at most ``MAX_SPLITS`` slices, each a
    multiple of the route's step.  Under a faithful accumulator
    (``accum_block`` > 0) a slice never straddles a rounding block: its
    depth divides ``accum_block``, or it is one whole block (unsplit where
    that would take more than ``MAX_SPLITS`` slices)."""
    if route not in SPLIT_STEP:
        raise ValueError(f"unknown route {route!r}; known: {sorted(SPLIT_STEP)}")
    step = SPLIT_STEP[route]
    whole = SplitPlan(1, N)
    tiles = (-(-max(M, 1) // tile.bm)) * (-(-max(K, 1) // tile.bk)) * max(batch, 1)
    steps = -(-N // step)
    if fused_bwd or tiles >= NUM_SMS or steps < 2 * MIN_SPLIT_STEPS:
        return whole
    want = min(MAX_SPLITS, -(-SPLIT_TARGET // tiles))
    depth = max(MIN_SPLIT_STEPS, -(-steps // want)) * step
    if accum_block:
        if depth >= accum_block:
            depth = accum_block
        else:  # the shallowest divisor of the block at least this deep
            depth = next(d for d in range(depth, accum_block + 1, step)
                         if accum_block % d == 0)
    splits = -(-N // depth)
    if splits <= 1 or splits > MAX_SPLITS:
        return whole
    return SplitPlan(splits, depth)


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

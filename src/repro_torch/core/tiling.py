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
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TileConfig", "choose_tiles", "smem_bytes", "GEMM_TILES",
           "SMEM_BUDGET", "FLASH_BQ", "FLASH_BKV"]

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

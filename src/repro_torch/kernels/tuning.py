"""Tile and split selection for the Hopper scan kernels.

Port of ``src/repro/kernels/tuning.py``.  The reference sized Pallas
tiles against half of a TPU core's VMEM; here the budget is one H100
thread block: 227 KB of shared memory (``SMEM_BUDGET``) out of the SM's
228 KB (``SM_SMEM``, 1 KB of it reserved per block), next to 64K 32-bit
registers per SM.  Every scan kernel runs 256 threads.  Two product
loops, two policies:

**SQ8 kernels** (``csrc/qtopk_seg.cu``; ``select_tiles``, ``smem_bytes``).
A 16×16 thread grid, each thread owning a (block_q/16)×(block_n/16)
register tile, so a tile is a multiple of 16 rows on each side and at
most 64×64.  The per-block working set is

    block_q·k·8                              running top-k keys (u64)
  + CHUNK_WORDS·(block_q + 1 + block_n + 1)·4   one d-chunk of both operands
  + block_q·(block_n + 1)·4                  distance tile (fp32)
  + (block_q + block_n)·16                   per-row / per-column scalars

``select_tiles`` grows the candidate axis first, then the query axis,
never past what the problem needs.

**fp32 kernels** (``csrc/topk_seg.cu``, ``csrc/pairwise.cu``;
``select_f32_tiles``, ``select_f32_splits``, ``f32_smem_bytes``).  Two
block tiles (``F32_TILES``): *wide* 128×128 with 8×8 outputs per thread,
and *narrow* 32×256 with 8×4, each operand fragment one float4 shared
load.  d is walked in ``F32_CHUNK``-word chunks through two shared
stages.  The per-block working set of the top-k pass is

    block_q·k·8                              running top-k keys (u64)
  + max(2·F32_CHUNK·(block_q + block_n),      the two operand stages, or
        block_q·(block_n + 4))·4               the distance tile over them
  + (5·block_q + 2·block_n)·4                per-row / per-column scalars
  + block_q·F32_CANDIDATES                   listed fold candidates (u8)

and of the pairwise block (k = 0, no lists, no distance tile: it stores
from registers) ``2·F32_CHUNK·(block_q + block_n)·4 + (2·block_q +
block_n)·4``.  The CUDA entry points compute the same sums.  Kernel A
(segmented) always takes the narrow tile: a small row tile keeps each
row tile's owners few, so the owner skip drops most (row tile, column
tile) pairs.  The unsegmented top-k and the pairwise kernel take the
wide tile when Q > 32 (and, for the top-k, when two blocks still fit on
an SM: k ≤ 39), else the narrow one.  Splits: enough blocks for two per
SM, and when segmented about ``F32_SEG_TILES_PER_SPLIT`` column tiles
per split, so a row tile's matched stretch of N spreads over many
blocks while blocks that meet nothing exit at once; the partial lists
(Q·S·k·8 bytes) stay under ``F32_PARTIAL_CAP``.

There is no interpret-mode or implementation switch: the device of the
tensors a wrapper is given chooses the path (CUDA kernel or its plain
PyTorch version).
"""

from __future__ import annotations

import math
from typing import Tuple

TILE_MULT = 16                  # rows per side of the 16×16 thread grid
MAX_BLOCK_Q = 64
MAX_BLOCK_N = 64
SMEM_BUDGET = 232_448           # bytes: 227 KB usable by one H100 block
CHUNK_WORDS = 32                # 32-bit words of one operand d-chunk
SM_COUNT = 132                  # H100 SXM
BLOCKS_PER_SM = 2               # split target: keep ≥ 2 blocks per SM
SM_SMEM = 233_472               # bytes of shared memory per H100 SM
SMEM_PER_BLOCK_RESERVED = 1024  # bytes the runtime keeps per block
THREADS = 256                   # threads per scan block
# fp32 kernels: block tile -> register tile (rows, columns) per thread
F32_WIDE = (128, 128)
F32_NARROW = (32, 256)
F32_TILES = {F32_WIDE: (8, 8), F32_NARROW: (8, 4)}
F32_CHUNK = 16                  # 32-bit words of one operand d-chunk
F32_CANDIDATES = 32             # listed fold candidates per row and tile
F32_SEG_TILES_PER_SPLIT = 4     # column tiles per split, segmented
F32_PARTIAL_CAP = 64 << 20      # bytes of partial lists per launch
# SQ8 eligibility: the executor falls back to the fp32 scan past this
# dim (see quant.sq8_supported); the int8 kernel takes any d up to it
SQ8_DIM_CAP = 4096


def smem_bytes(bq: int, bn: int, k: int) -> int:
    """Dynamic shared memory of one scan block (module docstring); k = 0
    is the pairwise kernel, which keeps no top-k lists."""
    return (bq * k * 8
            + CHUNK_WORDS * (bq + 1 + bn + 1) * 4
            + bq * (bn + 1) * 4
            + (bq + bn) * 16)


def select_tiles(q: int, n: int, *, k: int = 0) -> Tuple[int, int]:
    """Pick ``(block_q, block_n)`` for a (Q, d) × (N, d) scan kernel with
    a running top-k of width ``k`` (≤ 128; 0 for the pairwise kernel).
    The kernels walk d in chunks of ``CHUNK_WORDS`` 32-bit words whatever
    the dtype, so d and the operand type set the number of chunks, not
    the block's footprint."""
    bq = bn = TILE_MULT

    def fits(a: int, b: int) -> bool:
        return smem_bytes(a, b, k) <= SMEM_BUDGET

    while bn < MAX_BLOCK_N and bn < n and fits(bq, bn + TILE_MULT):
        bn += TILE_MULT
    while bq < MAX_BLOCK_Q and bq < q and fits(bq + TILE_MULT, bn):
        bq += TILE_MULT
    return bq, bn


def select_splits(q: int, n: int, block_q: int, block_n: int) -> int:
    """Number of N-splits S of the split-N pass: enough blocks in flight
    (grid = ceil(Q/block_q) × S ≥ BLOCKS_PER_SM·SM_COUNT) while every
    split keeps at least one candidate tile."""
    q_blocks = max(1, math.ceil(q / block_q))
    n_tiles = max(1, math.ceil(n / block_n))
    return max(1, min(n_tiles,
                      math.ceil(BLOCKS_PER_SM * SM_COUNT / q_blocks)))


def f32_smem_bytes(bq: int, bn: int, k: int) -> int:
    """Dynamic shared memory of one fp32 block (module docstring); k = 0
    is the pairwise kernel."""
    stages = 2 * F32_CHUNK * (bq + bn)
    if k == 0:
        return stages * 4 + (2 * bq + bn) * 4
    return bq * k * 8 + max(stages, bq * (bn + 4)) * 4 \
        + (5 * bq + 2 * bn) * 4 + bq * F32_CANDIDATES


def f32_blocks_per_sm(bq: int, bn: int, k: int) -> int:
    """Blocks of this tile that shared memory lets one SM hold."""
    return SM_SMEM // (f32_smem_bytes(bq, bn, k) + SMEM_PER_BLOCK_RESERVED)


def select_f32_tiles(q: int, *, k: int = 0,
                     segmented: bool = False) -> Tuple[int, int]:
    """Pick ``(block_q, block_n)`` of the fp32 kernels: the narrow tile
    for the segmented top-k and for Q ≤ 32, else the wide tile if two
    blocks of it fit on an SM at this k (k = 0: the pairwise kernel)."""
    if segmented or q <= F32_NARROW[0]:
        return F32_NARROW
    if f32_blocks_per_sm(*F32_WIDE, k) >= 2:
        return F32_WIDE
    return F32_NARROW


def select_f32_splits(q: int, n: int, block_q: int, block_n: int, *,
                      k: int, segmented: bool = False) -> int:
    """N-splits S of the fp32 split-N pass: ``select_splits``' two blocks
    per SM, raised when segmented to about ``F32_SEG_TILES_PER_SPLIT``
    column tiles per split while the partial lists (Q·S·k·8 bytes) stay
    under ``F32_PARTIAL_CAP``; at most one split per column tile."""
    s = select_splits(q, n, block_q, block_n)
    if segmented:
        n_tiles = max(1, math.ceil(n / block_n))
        cap = F32_PARTIAL_CAP // max(1, q * k * 8)
        s = max(s, min(math.ceil(n_tiles / F32_SEG_TILES_PER_SPLIT), cap))
    return min(s, 65_535)


__all__ = ["select_tiles", "select_splits", "smem_bytes", "SMEM_BUDGET",
           "MAX_BLOCK_Q", "MAX_BLOCK_N", "TILE_MULT", "CHUNK_WORDS",
           "SM_COUNT", "SQ8_DIM_CAP", "select_f32_tiles", "select_f32_splits",
           "f32_smem_bytes", "f32_blocks_per_sm", "F32_TILES", "F32_WIDE",
           "F32_NARROW", "F32_CHUNK", "THREADS"]

"""Tile and split selection for the Hopper scan kernels.

Port of ``src/repro/kernels/tuning.py``.  The reference sized Pallas
tiles against half of a TPU core's VMEM; here the budget is one H100
thread block: 227 KB of shared memory (``SMEM_BUDGET``) out of the SM's
228 KB (``SM_SMEM``, 1 KB of it reserved per block), next to 64K 32-bit
registers per SM.  Every scan kernel runs 256 threads.  Two product
loops, two policies:

**SQ8 kernels** (``csrc/qtopk_seg.cu``; ``SQ8_TILE``,
``select_sq8_splits``, ``sq8_smem_bytes``).  Int8 tensor-core products
(``mma.sync`` m16n8k32), eight warps of 32×32 outputs each over one
32×256 block tile.  d is walked in ``SQ8_CHUNK``-byte chunks through two
shared stages; a tile's fp32 distance tile, block_q·(block_n + 8)·4
bytes, lives in the stage its last chunk used.  The per-block working
set is

    2·SQ8_CHUNK·(block_q + block_n)          the two operand stages (int8)
  + (6·block_q + 3·block_n)·4                per-row / per-column scalars
  + block_q·CANDIDATES                       listed fold candidates (u8)
  + block_q·k·8                              running top-k keys (u64)

and the CUDA entry points compute the same sum: two blocks fit on an SM
up to k = 128.  The small row tile lets kernel B's owner skip bite, and
unsegmented it beat on the H100 a 128×64 tile that holds all Q = 128
rows (whose fold pays each row's overhead for 64 columns instead of
256; ``PERF.md``).  Splits:
``select_splits``' two blocks per SM, and when segmented about
``SQ8_SEG_TILES_PER_SPLIT`` column tiles per split (the kernel's
partial lists and merge cost more per split than kernel A's, so its
splits are longer).

**fp32 kernels A and C** (``csrc/topk_seg.cu``, ``csrc/pairwise.cu``;
``select_f32_tiles``, ``select_f32_splits``, ``f32_smem_bytes``).  Two
block tiles (``F32_TILES``): *wide* 128×128 with 8×8 outputs per thread,
and *narrow* 32×256 with 8×4, each operand fragment one float4 shared
load.  d is walked in ``F32_CHUNK``-word chunks through two shared
stages.  The per-block working set of the top-k pass is

    block_q·k·8                              running top-k keys (u64)
  + max(2·F32_CHUNK·(block_q + block_n),      the two operand stages, or
        block_q·(block_n + 4))·4               the distance tile over them
  + (5·block_q + 2·block_n)·4                per-row / per-column scalars
  + block_q·CANDIDATES                       listed fold candidates (u8)

and of the pairwise block (k = 0, no lists, no distance tile: it stores
from registers) ``2·F32_CHUNK·(block_q + block_n)·4 + (2·block_q +
block_n)·4``.  The CUDA entry points compute the same sums.  Kernel A
(segmented) always takes the narrow tile: a small row tile keeps each
row tile's owners few, so the owner skip drops most (row tile, column
tile) pairs.  The pairwise kernel takes the wide tile when Q > 32, else
the narrow one.  Splits: enough blocks for two per SM, and
when segmented about ``F32_SEG_TILES_PER_SPLIT`` column tiles per split,
so a row tile's matched stretch of N spreads over many blocks while
blocks that meet nothing exit at once; the partial lists (Q·S·k·8
bytes) stay under ``F32_PARTIAL_CAP``.

**The unsegmented fp32 top-k** (``csrc/topk_dense.cu``, ``topk_f32``;
``select_dense_tile``, ``select_dense_splits``, ``dense_smem_bytes``).
The same two block tiles (``DENSE_TILES``), operands copied
asynchronously into a ring of stages, each staged row padded by one
16-byte unit; ``DENSE_CHUNKS`` gives the words of a chunk and the
stages of each (tile, x resident) instantiation.  The per-block working
set is

    block_q·CANDIDATES·8                     listed candidate keys (u64)
  + (3·block_q + 2·block_n)·4                per-row / per-column scalars
  + 8·32·8                                   the union's lists (u64)
  + stages·rows·(chunk/4 + 1)·16             the ring (rows: block_n, or
                                             block_n + block_q when x streams)
  + block_q·k·8                              running top-k keys (u64)
  + ceil(d / chunk)·block_q·(chunk/4 + 1)·16 the resident x (if resident)

more than half an SM: one block an SM.  The tile: wide when Q > 32 and
it fits, x resident where it fits beside the ring, else streamed;
otherwise narrow, which fits every k ≤ 128 and every d.  Splits:
``DENSE_WAVES`` blocks per SM over the row tiles, every split the same
number of column tiles but the last.

There is no interpret-mode or implementation switch: the device of the
tensors a wrapper is given chooses the path (CUDA kernel or its plain
PyTorch version).
"""

from __future__ import annotations

import math
from typing import Tuple

SMEM_BUDGET = 232_448           # bytes: 227 KB usable by one H100 block
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
F32_SEG_TILES_PER_SPLIT = 4     # column tiles per split, segmented
F32_PARTIAL_CAP = 64 << 20      # bytes of partial lists per launch
CANDIDATES = 32                 # listed fold candidates per row and tile
# the unsegmented fp32 top-k: block tile -> register tile, as F32_TILES,
# and (block tile, x resident) -> (words of a d-chunk, stages of the ring)
DENSE_WIDE = (128, 128)
DENSE_NARROW = (32, 256)
DENSE_TILES = {DENSE_WIDE: (8, 8), DENSE_NARROW: (8, 4)}
DENSE_CHUNKS = {(DENSE_WIDE, True): (64, 3), (DENSE_WIDE, False): (32, 4),
                (DENSE_NARROW, True): (32, 4), (DENSE_NARROW, False): (32, 4)}
DENSE_WAVES = 1                 # waves of blocks the splits aim at
SQ8_TILE = (32, 256)            # SQ8 kernels' block tile (rows, columns)
SQ8_CHUNK = 128                 # bytes of an operand row in one d-chunk
SQ8_SEG_TILES_PER_SPLIT = 20    # column tiles per split, segmented
# SQ8 eligibility: the executor falls back to the fp32 scan past this
# dim (see quant.sq8_supported); the int8 kernel takes any d up to it
SQ8_DIM_CAP = 4096


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
        + (5 * bq + 2 * bn) * 4 + bq * CANDIDATES


def f32_blocks_per_sm(bq: int, bn: int, k: int) -> int:
    """Blocks of this tile that shared memory lets one SM hold."""
    return SM_SMEM // (f32_smem_bytes(bq, bn, k) + SMEM_PER_BLOCK_RESERVED)


def select_f32_tiles(q: int, *, segmented: bool = False) -> Tuple[int, int]:
    """Pick ``(block_q, block_n)`` of kernels A and C: the narrow tile for
    the segmented top-k and for Q ≤ 32, else the wide one."""
    if segmented or q <= F32_NARROW[0]:
        return F32_NARROW
    return F32_WIDE


def _splits(q: int, n: int, block_q: int, block_n: int, k: int,
            segmented: bool, per_split: int) -> int:
    s = select_splits(q, n, block_q, block_n)
    if segmented:
        n_tiles = max(1, math.ceil(n / block_n))
        cap = F32_PARTIAL_CAP // max(1, q * k * 8)
        s = max(s, min(math.ceil(n_tiles / per_split), cap))
    return min(s, 65_535)


def select_f32_splits(q: int, n: int, block_q: int, block_n: int, *,
                      k: int, segmented: bool = False) -> int:
    """N-splits S of the fp32 split-N pass: ``select_splits``' two blocks
    per SM, raised when segmented to about ``F32_SEG_TILES_PER_SPLIT``
    column tiles per split while the partial lists (Q·S·k·8 bytes) stay
    under ``F32_PARTIAL_CAP``; at most one split per column tile."""
    return _splits(q, n, block_q, block_n, k, segmented,
                   F32_SEG_TILES_PER_SPLIT)


def dense_smem_bytes(bq: int, bn: int, k: int, d: int,
                     resident: bool) -> int:
    """Dynamic shared memory of one ``topk_f32`` block (module
    docstring); the kernel computes the same sum."""
    chunk, stages = DENSE_CHUNKS[((bq, bn), resident)]
    unit = (chunk // 4 + 1) * 16
    rows = bn if resident else bn + bq
    return (bq * CANDIDATES * 8 + (3 * bq + 2 * bn) * 4 + 8 * 32 * 8
            + stages * rows * unit + bq * k * 8
            + (-(-d // chunk) * bq * unit if resident else 0))


def dense_blocks_per_sm(bq: int, bn: int, k: int, d: int,
                        resident: bool) -> int:
    """Blocks of ``topk_f32`` that shared memory lets one SM hold."""
    return SM_SMEM // (dense_smem_bytes(bq, bn, k, d, resident)
                       + SMEM_PER_BLOCK_RESERVED)


def select_dense_tile(q: int, d: int, k: int) -> Tuple[int, int, bool]:
    """``(block_q, block_n, resident)`` of ``topk_f32``: the wide tile
    when Q > 32 and it fits at this (d, k), x resident where it fits,
    else streamed; otherwise the narrow tile."""
    tiles = ([DENSE_WIDE] if q > DENSE_NARROW[0] else []) + [DENSE_NARROW]
    for bq, bn in tiles:
        for resident in (True, False):
            if dense_smem_bytes(bq, bn, k, d, resident) <= SMEM_BUDGET:
                return bq, bn, resident
    raise ValueError(f"no topk_f32 tile fits k={k}, d={d}")


def select_dense_splits(q: int, n: int, block_q: int, block_n: int, *,
                        k: int, d: int, resident: bool) -> int:
    """N-splits S of ``topk_f32``: ``DENSE_WAVES`` times the blocks the
    SMs hold at once, over the row tiles, at most one split per column
    tile, then evened so every split has the same number of column tiles
    but the last."""
    q_tiles = max(1, math.ceil(q / block_q))
    n_tiles = max(1, math.ceil(n / block_n))
    slots = DENSE_WAVES * SM_COUNT * max(1, dense_blocks_per_sm(
        block_q, block_n, k, d, resident))
    s = max(1, min(n_tiles, slots // q_tiles, 65_535))
    return math.ceil(n_tiles / math.ceil(n_tiles / s))


def sq8_smem_bytes(bq: int, bn: int, k: int) -> int:
    """Dynamic shared memory of one SQ8 pass block (module docstring)."""
    return (2 * SQ8_CHUNK * (bq + bn) + (6 * bq + 3 * bn) * 4
            + bq * CANDIDATES + bq * k * 8)


def select_sq8_splits(q: int, n: int, block_q: int, block_n: int, *,
                      k: int, segmented: bool = False) -> int:
    """N-splits S of the SQ8 split-N pass: the fp32 rule with
    ``SQ8_SEG_TILES_PER_SPLIT`` column tiles per split when segmented."""
    return _splits(q, n, block_q, block_n, k, segmented,
                   SQ8_SEG_TILES_PER_SPLIT)


__all__ = ["select_splits", "SMEM_BUDGET", "SM_COUNT", "SQ8_DIM_CAP",
           "select_f32_tiles", "select_f32_splits", "f32_smem_bytes",
           "f32_blocks_per_sm", "F32_TILES", "F32_WIDE", "F32_NARROW",
           "F32_CHUNK", "THREADS", "CANDIDATES", "select_sq8_splits",
           "sq8_smem_bytes", "SQ8_TILE", "SQ8_CHUNK", "DENSE_TILES",
           "DENSE_WIDE", "DENSE_NARROW", "DENSE_CHUNKS",
           "dense_smem_bytes", "dense_blocks_per_sm", "select_dense_tile",
           "select_dense_splits"]

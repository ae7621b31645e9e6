"""Tile and split selection for the Hopper scan kernels.

Port of ``src/repro/kernels/tuning.py``.  The reference sized Pallas
tiles against half of a TPU core's VMEM; here the budget is one H100
thread block: 227 KB of shared memory (``SMEM_BUDGET``) out of the SM's
256 KB, next to 64K 32-bit registers per SM.  The scan kernels
(``csrc/topk_seg.cu``, ``csrc/qtopk_seg.cu``, ``csrc/pairwise.cu``) run
256 threads as a 16×16 grid, each thread owning a (block_q/16)×
(block_n/16) register tile, so a tile is a multiple of 16 rows on each
side and at most 64×64; ptxas gives them 48–80 registers a thread, so
registers allow three to five blocks per SM and shared memory sets the
rest.  The per-block working set is

    block_q·k·8                              running top-k keys (u64)
  + CHUNK_WORDS·(block_q + 1 + block_n + 1)·4   one d-chunk of both operands
  + block_q·(block_n + 1)·4                  distance tile (fp32)
  + (block_q + block_n)·16                   per-row / per-column scalars

(``smem_bytes``; the CUDA entry points compute the same sum).  The
pairwise kernel (``csrc/pairwise.cu``) is the same block with k = 0: it
keeps no top-k lists, and its distance tile stages the output for
row-contiguous stores.  ``select_tiles`` grows the candidate axis first,
then the query axis, never past what the problem needs.  At the largest
tile and k = 128 the block needs about 100 KB, so the budget guards the
contract rather than binding today.

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


__all__ = ["select_tiles", "select_splits", "smem_bytes", "SMEM_BUDGET",
           "MAX_BLOCK_Q", "MAX_BLOCK_N", "TILE_MULT", "CHUNK_WORDS",
           "SM_COUNT", "SQ8_DIM_CAP"]

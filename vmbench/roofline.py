"""Peaks of one NVIDIA H100 SXM and the least time of a wave's scans.

The peaks are NVIDIA's data sheet's dense rates at the 700 W limit: HBM
at 3.35 TB/s, fp32 outside the tensor cores at 67 TFLOP/s, int8 on the
tensor cores at 1,979 TOP/s.  The arithmetic is ``chip_smoke.py``'s
(``_bound``), copied so that the yardstick does not move with that
script.

A wave's scan work is counted from the traffic the benchmark sent, the
same whatever implements the scan: for each distinct predicate p in the
wave, with q_p queries and |V_p| matching rows, every matching row is
read once and every query once, and each (query, row) pair costs 2·d
operations.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12

SQ8_ROW_EXTRA = 8            # fp32 scale and squared norm a row


def sq8_row_bytes(dim: int) -> int:
    return dim + SQ8_ROW_EXTRA


def f32_row_bytes(dim: int) -> int:
    return 4 * dim


def scan_work(counts: Dict[str, int], sizes: Dict[str, int], dim: int,
              row_bytes: int) -> Tuple[float, float]:
    """(bytes, operations) of one wave's scans."""
    byts = ops = 0.0
    for p, q in counts.items():
        rows = sizes[p]
        byts += rows * row_bytes + q * dim * 4
        ops += 2.0 * dim * q * rows
    return byts, ops


def least_seconds(byts: float, ops: float, peak_ops: float) -> float:
    """The larger of the byte time and the operation time."""
    return max(byts / PEAK_BYTES, ops / peak_ops)

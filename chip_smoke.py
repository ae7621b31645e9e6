#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports ``repro_torch``, torch and numpy only (no JAX), prints one JSON
object per line, and stops at the first failure with a non-zero exit.

Phases:
  1. card and build — the card's name and power limit, torch and CUDA
     versions; builds every CUDA kernel from ``src/repro_torch/kernels/
     csrc`` with nvcc and prints what ``-Xptxas -v`` reports;
  2. kernels vs plain at edge shapes (k = 128, ragged N, N < k, owners
     with no candidates, exact ties from duplicated rows, ip, bf16, d =
     97 (the scalar-load instantiation), d = 100 and 768, Q = 1 and 129,
     SQ8 at d = 4096, 8 and 130, Q = 1024 × N = 65,536 × d = 768 for the
     unsegmented kernels, and kernels A and B (B at kqp = 8, 40 and 128)
     under every owner layout of their tile skip:
     owner-sorted descriptor and tail runs, random owners, scattered
     tombstones, pad rows, an owner with no candidates, negative owners
     that match, ragged Q): the SQ8 kernels must be bit-equal to their
     plain versions, the fp32 ones within atol 1e-4·max|d| on values and
     equal on ids except where the distance is within that tolerance of a
     neighbour's; kernels A and B must compute exactly the (row tile,
     column tile) pairs that the plain skip rule keeps;
  3. the main path at SIFT1M shape — ``make_scale_corpus(1_048_576, 128)``
     indexed with ``VectorMatonConfig(T=10**9, backend="torch",
     device="cuda")``, 64-request batches of ``SCALE_PATTERNS`` plus one
     multi-segment LIKE (the residual path), under ``quantize="sq8"`` and
     ``"none"``; recall 1.0 against a brute-force oracle on the card; both
     kernels' launch counters must move, and their tile counters give
     the share of (row tile, column tile) pairs each computed.  Each
     kernel is then held
     against its plain version on the exact inputs the main path gave it
     and timed (CUDA events, warm) beside its plain version, the dense
     torch composition (matmul + masked_fill + topk), kernel B also
     beside ``torch._int_mm`` (its products alone), and its bound; then
     one direct ``quant.topk_sq8_segmented_desc`` call on the main path's
     last SQ8 inputs (the ``sq8_call`` line: kernel B and the
     certificate's owner maxima inside it, the latter beside the two
     ``scatter_reduce`` it replaced, bit-equal);
  4. unfiltered — the same resident 1,048,576 × 128 table through the
     unsegmented exact k-NN entry points, Q = 128 queries, k = 10:
     ``ops.topk`` (recall 1.0 against an fp64 brute force on the card),
     ``ops.pairwise_sqdist`` (l2 and ip, within 1e-4·max|d| of fp64) and
     ``quant.topk_sq8_rerank(overfetch=4)`` (recall ≥ 0.9, every distance
     the fp32 distance of its row); the three kernels' launch counters
     must move, and each is held against its plain version on the inputs
     the phase gave it and timed beside its plain version, the torch
     composition, the one PyTorch call where there is one, and its bound;
  5. serving, on the main path's index (not rebuilt): (a) checkpoint it
     to a temporary directory (bytes, save time) and restore it as a
     ``RetrievalEngine`` (time to the first answered wave; the answers
     must equal the original's); (b) one scripted stream — 32 read
     waves of 64 requests in segments of 8, write bursts of new
     scale records and deletes between segments, one forced compaction
     — through ``ContinuousBatcher(pipeline=False)`` and
     ``pipeline=True`` on engines restored from the checkpoint, under
     ``sq8`` and ``none``: every read equal across the two modes (ids,
     distances after rounding to 5 decimals), recall 1.0 against a brute
     force on the card, the same launches per wave in both modes; read
     QPS, wave p50, the ``pipeline_*`` counters and the device-busy share
     of 8 warm waves under the profiler, in turns (sync, pipelined,
     pipelined, sync); (c) a 2-replica
     ``ReplicaSet.from_engine`` behind a ``ReplicatedRouter``, one
     replica killed mid-churn and rejoined from the checkpoint plus a
     replay of the log: no request lost or duplicated, every answer
     equal to a single-replica oracle's, the rejoin time;
  6. graph states, inserts past the upload watermark, deletes and one
     compaction on ``make_corpus("code")`` with ``T=50, M=8, ef_con=60``:
     every wave equals the same index run through the port's plain
     PyTorch path on the CPU (near ties aside), graph-free requests equal
     the NumPy host oracle, and every answer is a live record that
     satisfies its predicate at its true distance; then one profiled
     wave (``graphs_profile``: the host time blocked in the beam's
     convergence checks and the copies);
  7. the ``kernels`` line; 8. the card line and the ``ok`` line.

``--phases build`` or ``--phases build,edges`` runs only those phases
and stops without the ``kernels`` and ``ok`` lines: a short check of new
kernels on the card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 CUDA-core
# FLOP/s, int8 tensor-core OP/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
K = 10


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def topk_agree(v_a, i_a, v_b, i_b, tol: float) -> None:
    """Two (R, k) ascending top-k results agree: the same (+inf, -1)
    slots, values within ``tol`` slot by slot, and the same ids among
    those clearly inside the top-k (more than 2·tol below the row's k-th
    value).  Ids within 2·tol of the k-th value are a near tie and may
    differ; so may the order of near-equal values inside."""
    v_a, v_b = np.asarray(v_a, np.float64), np.asarray(v_b, np.float64)
    i_a, i_b = np.asarray(i_a), np.asarray(i_b)
    fin = np.isfinite(v_b)
    check(np.array_equal(np.isfinite(v_a), fin), "(+inf, -1) slots differ")
    check(np.array_equal(i_a == -1, ~fin), "-1 ids outside +inf slots")
    check(np.array_equal(i_b == -1, ~fin), "-1 ids outside +inf slots")
    if not fin.any():
        return
    err = np.abs(v_a[fin] - v_b[fin]).max()
    check(err <= tol, f"values differ by {err} > {tol}")
    for r in range(v_b.shape[0]):
        f = fin[r]
        if not f.any() or np.array_equal(i_a[r][f], i_b[r][f]):
            continue
        kth = v_b[r][f][-1]
        inner_a = set(i_a[r][f][v_a[r][f] < kth - 2 * tol].tolist())
        inner_b = set(i_b[r][f][v_b[r][f] < kth - 2 * tol].tolist())
        check(inner_a == inner_b,
              f"row {r}: ids inside the top-k differ: "
              f"{sorted(inner_a ^ inner_b)}")


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------- #
# phase 1: card and build
# --------------------------------------------------------------------- #

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


KERNEL_NAMES = ("topk_f32_pass", "pairwise_f32_pass", "qtopk_seg_pass",
                "merge_flagged_partials", "tile_owner_ranges")


def ptxas_summary(log: str):
    """One ``"name<template args>: R regs, S/L spill bytes"`` string per
    kernel from the ``-Xptxas -v`` log (template flags and ints in
    declaration order, e.g. ``topk_f32_pass<SEG,L2,BF16,VEC,BQ,BN,TM,TN>``),
    and the kernels that spill."""
    import re
    out, spills, name, spill = [], [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled)
            args = re.findall(r"L[bi](\d+)E", mangled)
            name = base + (f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill[0]}/{spill[1]} "
                       "spill bytes")
            if spill != (0, 0):
                spills.append(name)
            name, spill = None, (0, 0)
    return out, spills


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas, spills = ptxas_summary(_build.build_log())
    emit(phase="build", seconds=build_s, dir=str(_build.build_dir()),
         ptxas=ptxas, spilling_kernels=spills)
    _build.library()


# --------------------------------------------------------------------- #
# phase 2: kernels vs plain at edge shapes
# --------------------------------------------------------------------- #

def _seg_case(rng, q, n, d, n_owners, dup=False):
    x = rng.standard_normal((q, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    if dup:                       # exact ties: every row appears 3 times
        y = np.repeat(y[: (n + 2) // 3], 3, axis=0)[:n]
    qseg = rng.integers(-1, n_owners + 2, q).astype(np.int32)
    cseg = rng.integers(0, n_owners, n).astype(np.int32)
    cseg[rng.random(n) < 0.05] = -3
    return x, y, qseg, cseg


def check_close_topk(kernel, plain, *args, **kwargs):
    """An fp32 top-k kernel vs its plain version on the same CUDA
    tensors: values within 1e-4·max|d|, ids equal except near ties.
    Returns (max abs error, tolerance)."""
    vk, ik = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    vp, ip = plain(*args, **kwargs)
    torch.cuda.synchronize()
    vp_h = host(vp)
    fin = np.isfinite(vp_h)
    scale = float(np.abs(vp_h[fin]).max()) if fin.any() else 1.0
    tol = 1e-4 * max(scale, 1.0)
    topk_agree(host(vk), host(ik), vp_h, host(ip), tol)
    err = float(np.abs(host(vk)[fin] - vp_h[fin]).max()) if fin.any() \
        else 0.0
    return err, tol


def check_bit_equal(kernel, plain, *args):
    """An SQ8 top-k kernel vs its plain version: bit-equal values and
    indices."""
    vk, ik = kernel(*args)
    torch.cuda.synchronize()
    vp, ip = plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(vk, vp), f"{kernel.__name__} values differ from plain")
    check(torch.equal(ik, ip), f"{kernel.__name__} indices differ from plain")
    return 0.0


def check_pairwise(x, y, metric="l2", accum="f32"):
    """The pairwise kernel vs its plain version: every entry within
    1e-4·max|d|.  Returns (max abs error, tolerance)."""
    from repro_torch.kernels.distance_topk import dense_distance
    from repro_torch.kernels.pairwise import pairwise_distance
    got = pairwise_distance(x, y, metric=metric, accum=accum)
    torch.cuda.synchronize()
    want = dense_distance(x, y, metric=metric, accum=accum)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"pairwise shape {tuple(got.shape)}")
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    check(err <= tol, f"pairwise_f32 differs from plain by {err} > {tol}")
    return err, tol


def check_kernel_a(x, y, qseg, cseg, kp, metric="l2", accum="f32"):
    """Kernel A vs its plain version on the same CUDA tensors."""
    from repro_torch.kernels.distance_topk import (segmented_dense_topk,
                                                   topk_seg_f32)
    return check_close_topk(topk_seg_f32, segmented_dense_topk, x, y, qseg,
                            cseg, kp, metric=metric, accum=accum)


def check_kernel_b(xq, yq, sx, x2, sy, y2, qseg, cseg, kqp):
    """Kernel B vs its plain version: bit-equal values and indices."""
    from repro_torch.kernels.quant import qtopk_seg_sq8, sq8_dense_segmented
    return check_bit_equal(qtopk_seg_sq8, sq8_dense_segmented, xq, yq, sx,
                           x2, sy, y2, qseg, cseg, kqp)


def _sq8_inputs(x, y, qseg, cseg, dev):
    from repro_torch.kernels.quant import quantize_sq8
    xq, sx, x2 = quantize_sq8(torch.from_numpy(x).to(dev))
    yq, sy, y2 = quantize_sq8(torch.from_numpy(y).to(dev))
    return (xq, yq, sx[:, 0].contiguous(), x2[:, 0].contiguous(),
            sy[:, 0].contiguous(), y2[:, 0].contiguous(),
            torch.from_numpy(qseg).to(dev), torch.from_numpy(cseg).to(dev))


def owner_layout(rng, name, q, n, n_owners=6):
    """(qseg, cseg) int32 of one owner layout of kernel A's tile skip (the
    CPU tests hold the skip rule to the reference on the same layouts):

    runs       owner-sorted descriptor runs then owner-sorted tail runs,
               rows sorted by owner, a few -3 tombstones (tiles straddle
               run boundaries);
    random     unsorted random owners on both sides;
    tombstones runs with 30 % of the columns scattered -3;
    pad_rows   runs, a third of the rows -1 (pad rows meet nothing);
    empty      runs, some rows owning an owner with no candidates;
    negative   runs, rows and a stretch of columns owning -5 (negative
               owners that match);
    ragged_q   runs with Q not a multiple of the row tile (the caller
               picks such a q)."""
    if name == "random":
        qseg = rng.integers(-1, n_owners + 2, q)
        cseg = rng.integers(-3, n_owners, n)
        return qseg.astype(np.int32), cseg.astype(np.int32)
    cut = n // 2
    cseg = np.concatenate([np.sort(rng.integers(0, n_owners, cut)),
                           np.sort(rng.integers(0, n_owners, n - cut))])
    qseg = np.sort(rng.integers(0, n_owners, q))
    tomb = 0.3 if name == "tombstones" else 0.02
    cseg[rng.random(n) < tomb] = -3
    if name == "pad_rows":
        qseg[-(q // 3):] = -1
    if name == "empty":
        qseg[: q // 4] = n_owners + 7
    if name == "negative":
        qseg[: q // 4] = -5
        cseg[n // 3: n // 3 + n // 10] = -5
    return qseg.astype(np.int32), cseg.astype(np.int32)


OWNER_LAYOUTS = ("runs", "random", "tombstones", "pad_rows", "empty",
                 "negative", "ragged_q")


def check_skip_count(qseg, cseg, kernel="topk_seg_f32"):
    """Kernel A (or B) computed exactly the (row tile, column tile) pairs
    that the plain skip rule keeps (``tile_owner_ranges`` + ``tiles_meet``)
    at its tiles, over the launches since ``reset_tile_stats``."""
    from repro_torch.kernels.distance_topk import (tile_owner_ranges,
                                                   tile_stats, tiles_meet)
    from repro_torch.kernels.tuning import SQ8_TILE, select_f32_tiles
    if kernel == "topk_seg_f32":
        bq, bn = select_f32_tiles(qseg.shape[0], segmented=True)
    else:
        bq, bn = SQ8_TILE
    rows = tile_owner_ranges(qseg[torch.argsort(qseg, stable=True)], bq)
    keep = tiles_meet(rows, tile_owner_ranges(cseg, bn))
    stats = tile_stats(kernel)
    check(stats == {"computed": int(keep.sum()), "total": keep.numel()},
          f"{kernel} computed {stats}, the rule keeps {int(keep.sum())} "
          f"of {keep.numel()}")
    return stats


def phase_edges() -> None:
    from repro_torch.kernels import distance_topk
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = [
        # name, q, n, d, owners, kp, metric, accum, dup
        ("k128", 100, 5000, 128, 3, 128, "l2", "f32", False),
        ("ragged_n", 70, 1037, 64, 4, 16, "l2", "f32", False),
        ("no_owner_rows", 33, 600, 32, 40, 24, "l2", "f32", False),
        ("ties", 64, 900, 48, 2, 40, "l2", "f32", True),
        ("ip", 128, 3000, 128, 5, 16, "ip", "f32", False),
        ("bf16", 128, 3000, 128, 5, 16, "l2", "bf16", False),
        ("d100", 50, 777, 100, 3, 32, "l2", "f32", False),
        ("d97", 50, 777, 97, 3, 32, "l2", "f32", False),
        ("d768", 64, 3000, 768, 3, 16, "l2", "f32", False),
        ("q1", 1, 3000, 128, 2, 16, "l2", "f32", False),
        ("q129", 129, 3000, 128, 5, 16, "ip", "f32", False),
    ]
    for name, q, n, d, owners, kp, metric, accum, dup in cases:
        x, y, qseg, cseg = _seg_case(rng, q, n, d, owners, dup)
        t = [torch.from_numpy(a).to(dev) for a in (x, y, qseg, cseg)]
        distance_topk.reset_tile_stats()
        err, tol = check_kernel_a(*t, kp, metric=metric, accum=accum)
        tiles = check_skip_count(t[2], t[3])
        emit(phase="edges", kernel="topk_seg_f32", case=name,
             max_abs_err=err, tol=tol, tiles=tiles)
    for layout in OWNER_LAYOUTS:
        for accum, metric in (("f32", "l2"), ("bf16", "ip")):
            q = 203 if layout == "ragged_q" else 128
            x = rng.standard_normal((q, 128)).astype(np.float32)
            y = rng.standard_normal((20_000, 128)).astype(np.float32)
            qseg, cseg = owner_layout(rng, layout, q, 20_000)
            t = [torch.from_numpy(a).to(dev) for a in (x, y, qseg, cseg)]
            distance_topk.reset_tile_stats()
            err, tol = check_kernel_a(*t, 16, metric=metric, accum=accum)
            tiles = check_skip_count(t[2], t[3])
            emit(phase="edges", kernel="topk_seg_f32",
                 case=f"layout_{layout}_{accum}", max_abs_err=err, tol=tol,
                 tiles=tiles)
    for name, q, n, d, owners, kp, dup in [
            ("k128", 100, 5000, 128, 3, 128, False),
            ("ragged_n", 70, 1037, 64, 4, 40, False),
            ("no_owner_rows", 33, 600, 32, 40, 24, False),
            ("ties", 64, 900, 48, 2, 40, True),
            ("d4096", 40, 700, 4096, 3, 40, False),
            ("d100", 50, 777, 100, 3, 32, False),
            ("d8_k8", 37, 2049, 8, 3, 8, False),
            ("d130_q129", 129, 3001, 130, 5, 40, False),
            ("q1", 1, 3000, 128, 2, 40, False)]:
        x, y, qseg, cseg = _seg_case(rng, q, n, d, owners, dup)
        t = _sq8_inputs(x, y, qseg, cseg, dev)
        distance_topk.reset_tile_stats()
        check_kernel_b(*t, kp)
        tiles = check_skip_count(t[6], t[7], "qtopk_seg_sq8")
        emit(phase="edges", kernel="qtopk_seg_sq8", case=name,
             max_abs_err=0.0, bit_equal=True, tiles=tiles)
    for layout in OWNER_LAYOUTS:
        for kp in (8, 40, 128):
            q = 203 if layout == "ragged_q" else 128
            x = rng.standard_normal((q, 128)).astype(np.float32)
            y = rng.standard_normal((20_000, 128)).astype(np.float32)
            qseg, cseg = owner_layout(rng, layout, q, 20_000)
            t = _sq8_inputs(x, y, qseg, cseg, dev)
            distance_topk.reset_tile_stats()
            check_kernel_b(*t, kp)
            tiles = check_skip_count(t[6], t[7], "qtopk_seg_sq8")
            emit(phase="edges", kernel="qtopk_seg_sq8",
                 case=f"layout_{layout}_k{kp}", max_abs_err=0.0,
                 bit_equal=True, tiles=tiles)
    phase_edges_unsegmented(dev, rng)


def phase_edges_unsegmented(dev, rng) -> None:
    """The unsegmented kernels (``topk_f32``, ``qtopk_sq8``,
    ``pairwise_f32``) against their plain versions at edge shapes, up to
    the largest shape of ``benchmarks/bench_kernels.py``."""
    from repro_torch.kernels.distance_topk import dense_topk, distance_topk
    from repro_torch.kernels.quant import (quantize_sq8, quantized_topk,
                                           sq8_dense)
    from repro_torch.kernels.tuning import F32_WIDE, select_f32_tiles

    def case(q, n, d, dup=False):
        x, y, _, _ = _seg_case(rng, q, n, d, 1, dup)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    big = (1024, 65_536, 768)
    k_wide = max(k for k in range(1, 129)            # the wide tile's
                 if select_f32_tiles(128, k=k) == F32_WIDE)   # largest k
    for name, shape, kp, metric, accum, dup in [
            ("k128", (100, 5000, 128), 128, "l2", "f32", False),
            ("k_wide_max", (128, 5000, 128), k_wide, "l2", "f32", False),
            ("ragged_n", (70, 1037, 64), 16, "l2", "f32", False),
            ("n_below_k", (33, 50, 32), 64, "l2", "f32", False),
            ("ties", (64, 900, 48), 40, "l2", "f32", True),
            ("ip", (128, 3000, 128), 16, "ip", "f32", False),
            ("bf16", (128, 3000, 128), 16, "l2", "bf16", False),
            ("d100", (50, 777, 100), 32, "l2", "f32", False),
            ("d97", (50, 777, 97), 32, "l2", "f32", False),
            ("q1", (1, 3000, 128), 16, "l2", "f32", False),
            ("q129", (129, 3000, 128), 16, "ip", "f32", False),
            ("bench_max", big, 16, "l2", "f32", False)]:
        x, y = case(*shape, dup=dup)
        err, tol = check_close_topk(distance_topk, dense_topk, x, y, kp,
                                    metric=metric, accum=accum)
        emit(phase="edges", kernel="topk_f32", case=name, max_abs_err=err,
             tol=tol)
    for name, shape, kp, dup in [
            ("k128", (100, 5000, 128), 128, False),
            ("ragged_n", (70, 1037, 64), 40, False),
            ("n_below_k", (33, 50, 32), 64, False),
            ("ties", (64, 900, 48), 40, True),
            ("d4096", (40, 700, 4096), 40, False),
            ("d100", (50, 777, 100), 32, False),
            ("q128_k40", (128, 4097, 128), 40, False),
            ("d130_q129_k8", (129, 2049, 130), 8, False),
            ("d8", (33, 3000, 8), 8, False),
            ("q1", (1, 3000, 128), 40, False),
            ("bench_max", big, 40, False)]:
        x, y = case(*shape, dup=dup)
        xq, sx, x2 = quantize_sq8(x)
        yq, sy, y2 = quantize_sq8(y)
        check_bit_equal(quantized_topk, sq8_dense, xq, sx[:, 0].contiguous(),
                        x2[:, 0].contiguous(), yq, sy[:, 0].contiguous(),
                        y2[:, 0].contiguous(), kp)
        emit(phase="edges", kernel="qtopk_sq8", case=name, max_abs_err=0.0,
             bit_equal=True)
    for name, shape, metric, accum in [
            ("l2", (100, 5000, 128), "l2", "f32"),
            ("ragged_n", (70, 1037, 64), "l2", "f32"),
            ("ip", (128, 3000, 128), "ip", "f32"),
            ("bf16", (128, 3000, 128), "l2", "bf16"),
            ("ip_bf16", (5, 70, 33), "ip", "bf16"),
            ("d100", (50, 777, 100), "l2", "f32"),
            ("d97", (50, 777, 97), "l2", "f32"),
            ("q1", (1, 3000, 128), "ip", "f32"),
            ("q129", (129, 3001, 128), "l2", "f32"),
            ("bench_max", big, "l2", "f32")]:
        x, y = case(*shape)
        err, tol = check_pairwise(x, y, metric=metric, accum=accum)
        emit(phase="edges", kernel="pairwise_f32", case=name,
             max_abs_err=err, tol=tol)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 3: main path at SIFT1M shape
# --------------------------------------------------------------------- #

class Capture:
    """Record the arguments of the last call of a module-level kernel
    wrapper (the executor looks it up by name at call time).  The
    wrapper counts its launches on itself through the same name, so
    ``launches`` passes through to the wrapped function."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

    def __call__(self, *args, **kwargs):
        self.args = (args, kwargs)
        return self.fn(*args, **kwargs)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def matching_rows(seqs, patterns):
    """Ids whose sequence satisfies each distinct predicate (host scan)."""
    from repro_torch.core.predicate import Contains, as_predicate
    out = {}
    for p in dict.fromkeys(patterns):
        pred = as_predicate(p)
        if isinstance(pred, Contains):
            hit = [i for i, s in enumerate(seqs) if p in s]
        else:
            hit = [i for i, s in enumerate(seqs) if pred.matches(s)]
        out[p] = np.asarray(hit, np.int64)
    return out


def brute_force(vectors_dev, rows_of, queries, patterns, k):
    """Exact filtered top-k on the card: per distinct predicate, the fp32
    distance to every matching row, then a stable top-k."""
    out = [None] * len(patterns)
    for p, rows in rows_of.items():
        reqs = [r for r, pp in enumerate(patterns) if pp == p]
        qd = torch.from_numpy(queries[reqs]).to(vectors_dev.device)
        if len(rows) == 0:
            for r in reqs:
                out[r] = (np.empty(0, np.float32), np.empty(0, np.int64))
            continue
        y = vectors_dev[torch.from_numpy(rows).to(vectors_dev.device)]
        if len(rows) * len(reqs) < 2 ** 22:     # difference form if small
            dist = ((y[None] - qd[:, None, :]) ** 2).sum(-1)
        else:
            dist = ((qd * qd).sum(1, keepdim=True) + (y * y).sum(1)
                    - 2.0 * qd @ y.T).clamp_min(0.0)
        kk = min(k, len(rows))
        pos = torch.argsort(dist, dim=1, stable=True)[:, :kk]
        dv, di = host(dist.gather(1, pos)), rows[host(pos)]
        for j, r in enumerate(reqs):
            out[r] = (dv[j], di[j])
    return out


def recall_check(res, oracle, tol_rel=1e-4):
    """Recall of ``res`` against ``oracle`` counting a near tie at the
    k-th place as a hit; both must agree as top-k lists."""
    hits = total = 0
    for (d, i), (od, oi) in zip(res, oracle):
        check(len(i) == len(oi), f"{len(i)} results, oracle {len(oi)}")
        if not len(oi):
            continue
        tol = tol_rel * max(float(np.abs(od).max()), 1.0)
        topk_agree(d[None], i[None], od[None], oi[None], tol)
        inner = set(oi[od < od[-1] - 2 * tol].tolist())
        hits += len(inner & set(i.tolist())) + (len(oi) - len(inner))
        total += len(oi)
    return hits / max(total, 1)


def _bound(bytes_, ops, peak_ops):
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _live_pairs(qseg: torch.Tensor, cseg: torch.Tensor):
    """(matched (row, column) pairs, live columns) of a segmented scan."""
    owners = torch.unique(qseg[qseg >= 0])
    rows_per = torch.stack([(qseg == o).sum() for o in owners]) \
        if len(owners) else torch.zeros(0, device=qseg.device)
    cols_per = torch.stack([(cseg == o).sum() for o in owners]) \
        if len(owners) else torch.zeros(0, device=qseg.device)
    return (int((rows_per.double() * cols_per.double()).sum()),
            int(cols_per.sum()))


def measure_kernel_a(args, kwargs, launches, tiles):
    """``tiles``: the (row tile, column tile) pairs kernel A computed and
    launched over the main path's run; ``tiles_one_call`` the same for
    the one call measured here."""
    from repro_torch.kernels import distance_topk, tuning
    from repro_torch.kernels.distance_topk import (segmented_dense_topk,
                                                   topk_seg_f32)
    from repro_torch.kernels.tuning import select_f32_tiles
    x, y, qseg, cseg, kp = args
    metric, accum = kwargs.get("metric", "l2"), kwargs.get("accum", "f32")
    distance_topk.reset_tile_stats()
    err, tol = check_kernel_a(x, y, qseg, cseg, kp, metric=metric,
                              accum=accum)
    one_call = check_skip_count(qseg, cseg)
    ms = cuda_ms(lambda: topk_seg_f32(x, y, qseg, cseg, kp, metric=metric,
                                      accum=accum))
    by_split = {}                  # the split policy's choice, against others
    default = tuning.F32_SEG_TILES_PER_SPLIT
    try:
        for per_split in (2, 4, 8):
            tuning.F32_SEG_TILES_PER_SPLIT = per_split
            by_split[per_split] = cuda_ms(lambda: topk_seg_f32(
                x, y, qseg, cseg, kp, metric=metric, accum=accum))
    finally:
        tuning.F32_SEG_TILES_PER_SPLIT = default
    plain_ms = cuda_ms(lambda: segmented_dense_topk(
        x, y, qseg, cseg, kp, metric=metric, accum=accum), reps=3)

    def composition():
        xy = x @ y.T
        dist = ((x * x).sum(1, keepdim=True) + (y * y).sum(1) - 2.0 * xy)
        dist = dist.masked_fill(qseg[:, None] != cseg[None, :],
                                float("inf"))
        return torch.topk(dist, kp, dim=1, largest=False)

    comp_ms = cuda_ms(composition, reps=3)
    pairs, live = _live_pairs(qseg, cseg)
    q, d = x.shape
    n = y.shape[0]
    bytes_ = q * d * 4 + live * d * 4 + (q + n) * 4 + q * kp * 8
    bound_ms, bound_by = _bound(bytes_, 2 * pairs * d, PEAK_F32)
    bq, bn = select_f32_tiles(q, k=kp, segmented=True)
    computed_flop = 2 * one_call["computed"] * bq * bn * d
    return {"name": "topk_seg_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_seg.cu",
            "replaces": "src/repro/kernels/distance_topk.py:97",
            "launches": launches, "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "composition_ms": comp_ms,
            "tiles": {**tiles, "share": tiles["computed"] / tiles["total"]},
            "tiles_one_call": one_call,
            "ms_by_tiles_per_split": by_split,
            "computed_tflops": computed_flop / ms / 1e9,
            "shape": {"Qp": q, "N": n, "d": d, "kp": kp, "bq": bq, "bn": bn,
                      "matched_pairs": pairs, "live_columns": live}}


def int_mm_ms(xq, yq):
    """``torch._int_mm(xq, yq.T)`` alone (cuBLASLt int8 products to an
    int32 matrix, no distance or top-k): a yardstick for the products,
    timed here and never called by the port; None where its shape rules
    (rows > 16, d a multiple of 8) refuse the inputs."""
    if xq.shape[0] <= 16 or xq.shape[1] % 8:
        return None
    return cuda_ms(lambda: torch._int_mm(xq, yq.T), reps=3)


def measure_kernel_b(args, launches, tiles):
    """``tiles``: the (row tile, column tile) pairs kernel B computed and
    launched over the main path's run; ``tiles_one_call`` the same for
    the one call measured here."""
    from repro_torch.kernels import distance_topk, tuning
    from repro_torch.kernels.quant import qtopk_seg_sq8, sq8_dense_segmented
    xq, yq, sx, x2, sy, y2, qseg, cseg, kqp = args
    distance_topk.reset_tile_stats()
    err = check_kernel_b(*args)
    one_call = check_skip_count(qseg, cseg, "qtopk_seg_sq8")
    ms = cuda_ms(lambda: qtopk_seg_sq8(*args))
    by_split = {}                  # the split policy's choice, against others
    default = tuning.SQ8_SEG_TILES_PER_SPLIT
    try:
        for per_split in (10, 20, 40):
            tuning.SQ8_SEG_TILES_PER_SPLIT = per_split
            by_split[per_split] = cuda_ms(lambda: qtopk_seg_sq8(*args))
    finally:
        tuning.SQ8_SEG_TILES_PER_SPLIT = default
    plain_ms = cuda_ms(lambda: sq8_dense_segmented(*args), reps=3)

    def composition():
        dot = xq.float() @ yq.float().T         # exact: d·127² < 2²⁴
        dist = ((x2[:, None] + y2[None, :])
                - 2.0 * (dot * sx[:, None]) * sy[None, :])
        dist = dist.masked_fill(qseg[:, None] != cseg[None, :],
                                float("inf"))
        return torch.topk(dist, kqp, dim=1, largest=False)

    comp_ms = cuda_ms(composition, reps=3)
    mm_ms = int_mm_ms(xq, yq)
    torch.cuda.empty_cache()
    pairs, live = _live_pairs(qseg, cseg)
    q, d = xq.shape
    n = yq.shape[0]
    bytes_ = q * (d + 8) + live * (d + 8) + (q + n) * 4 + q * kqp * 8
    bound_ms, bound_by = _bound(bytes_, 2 * pairs * d, PEAK_INT8)
    bq, bn = tuning.SQ8_TILE
    computed_ops = 2 * one_call["computed"] * bq * bn * d
    return {"name": "qtopk_seg_sq8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/qtopk_seg.cu",
            "replaces": "src/repro/kernels/quant.py:162",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call ranks distances",
            "composition_ms": comp_ms, "int_mm_ms": mm_ms,
            "achieved_gbps": bytes_ / ms / 1e6,
            "computed_tops": computed_ops / ms / 1e9,
            "tiles": {**tiles, "share": tiles["computed"] / tiles["total"]},
            "tiles_one_call": one_call,
            "ms_by_tiles_per_split": by_split,
            "shape": {"Qp": q, "N": n, "d": d, "kqp": kqp, "bq": bq,
                      "bn": bn, "matched_pairs": pairs,
                      "live_columns": live}}


def measure_sq8_call(call):
    """One direct ``quant.topk_sq8_segmented_desc`` call on the inputs the
    main path's last SQ8 wave gave it (gathers + kernel B + rerank +
    certificate): its time, kernel B's and the certificate's owner
    maxima (``quant.owner_max``) on the call's own inputs beside the two
    ``scatter_reduce(amax)`` they replace (bit-equal), and the call's
    device profile."""
    from repro_torch.kernels import quant
    args, kwargs = call
    fn = quant.topk_sq8_segmented_desc
    with Capture(quant, "owner_max") as cap_om, \
            Capture(quant, "qtopk_seg_sq8") as cap_b:
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    call_ms = cuda_ms(lambda: fn(*args, **kwargs))
    kernel_b_ms = cuda_ms(lambda: quant.qtopk_seg_sq8(*cap_b.args[0]))
    own, vals, n_owners = cap_om.args[0]
    om_ms = cuda_ms(lambda: quant.owner_max(own, vals, n_owners))

    def scatter_pair():
        return torch.stack([torch.zeros(n_owners, device=own.device)
                            .scatter_reduce(0, own, vals[:, c].contiguous(),
                                            "amax")
                            for c in range(vals.shape[1])], 1)

    check(torch.equal(quant.owner_max(own, vals, n_owners), scatter_pair()),
          "owner_max differs from scatter_reduce(amax)")
    sr_ms = cuda_ms(scatter_pair, reps=3)
    wall_ms, busy, top = device_profile(lambda: fn(*args, **kwargs))
    out = {"call_ms": call_ms, "kernel_b_ms": kernel_b_ms,
           "owner_max_ms": om_ms, "scatter_reduce_pair_ms": sr_ms,
           "owner_max_share_of_call": om_ms / call_ms,
           "owner_max_below_kernel_b": om_ms < kernel_b_ms,
           "candidates": int(own.shape[0]), "owners": n_owners,
           "profiled_wall_ms": wall_ms, "profiled_device_busy_ms": busy,
           "profiled_top": top}
    emit(phase="sq8_call", **out)
    return out


def phase_main_path():
    from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
    from repro_torch.data.corpora import SCALE_PATTERNS, make_scale_corpus
    from repro_torch.core import packed
    from repro_torch.kernels import distance_topk, ops, quant

    t0 = time.perf_counter()
    vecs, seqs = make_scale_corpus(1_048_576, 128)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vm = VectorMaton(vecs, seqs, VectorMatonConfig(
        T=10 ** 9, backend="torch", device="cuda"))
    rt = vm.runtime
    rt.to_device()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit(phase="main_build", n=len(vecs), d=vecs.shape[1],
         generate_s=gen_s, build_and_upload_s=build_s,
         states=rt.stats()["states"], graph_states=len(rt.graphs))

    rng = np.random.default_rng(1)
    patterns = [SCALE_PATTERNS[i % len(SCALE_PATTERNS)] for i in range(63)]
    patterns.append("LIKE '%a%c%'")
    waves = 16
    qsets = [(vecs[rng.integers(0, len(vecs), 64)]
              + 0.3 * rng.standard_normal((64, 128))).astype(np.float32)
             for _ in range(waves)]
    strategies = dict(vm.plan(patterns, rt).strategies)

    # warm-up wave per mode (first calls load the kernel library)
    for mode in ("sq8", "none"):
        rt.quantize = mode
        vm.query_batch(qsets[0], patterns, K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_stats()
    distance_topk.topk_seg_f32.launches = 0
    quant.qtopk_seg_sq8.launches = 0
    distance_topk.reset_tile_stats()
    results = {}
    wave_ms = {"sq8": [], "none": []}
    host_ms = {}
    sq8_before = dict(rt.sq8_stats)
    with Capture(distance_topk, "topk_seg_f32") as cap_a, \
            Capture(quant, "qtopk_seg_sq8") as cap_b, \
            Capture(packed, "topk_sq8_segmented_desc") as cap_call:
        for mode in ("sq8", "none"):
            rt.quantize = mode
            before = dict(rt.wave_times)
            for w in range(waves):
                t0 = time.perf_counter()
                res = vm.query_batch(qsets[w], patterns, K)
                torch.cuda.synchronize()
                wave_ms[mode].append((time.perf_counter() - t0) * 1e3)
                results[(mode, w)] = res
            host_ms[mode] = {key: (rt.wave_times[key] - before[key]) / waves
                             for key in before}
    stats = ops.launch_stats()
    tiles_a = distance_topk.tile_stats()
    tiles_b = distance_topk.tile_stats("qtopk_seg_sq8")
    launches_a = distance_topk.topk_seg_f32.launches
    launches_b = quant.qtopk_seg_sq8.launches
    sq8 = {k: rt.sq8_stats[k] - sq8_before[k] for k in rt.sq8_stats}
    peak = torch.cuda.max_memory_allocated()
    check(stats.get("sq8_scan", 0) >= 1, f"no sq8_scan launch: {stats}")
    check(stats.get("desc_scan", 0) >= 1, f"no desc_scan launch: {stats}")
    check(launches_a > 0, "kernel A never launched on the main path")
    check(0 < tiles_a["computed"] <= tiles_a["total"],
          f"kernel A tile counts {tiles_a}")
    check(launches_b > 0, "kernel B never launched on the main path")
    check(0 < tiles_b["computed"] <= tiles_b["total"],
          f"kernel B tile counts {tiles_b}")

    dev_vecs = rt.to_device()["vectors"]
    rows_of = matching_rows(seqs, patterns)
    recalls = []
    for w in range(waves):
        oracle = brute_force(dev_vecs, rows_of, qsets[w], patterns, K)
        for mode in ("sq8", "none"):
            rec = recall_check(results[(mode, w)], oracle)
            check(rec == 1.0, f"recall {rec} < 1.0 ({mode}, wave {w})")
            recalls.append(rec)
    emit(phase="main_path", patterns=sorted(set(patterns)),
         strategies=strategies, k=K, waves_per_mode=waves,
         recall=min(recalls), launch_stats=stats,
         kernel_launches={"topk_seg_f32": launches_a,
                          "qtopk_seg_sq8": launches_b},
         kernel_a_tiles=tiles_a, kernel_b_tiles=tiles_b,
         sq8_stats=sq8,
         wave_ms_p25_p50_p75={m: np.percentile(v, [25, 50, 75]).tolist()
                              for m, v in wave_ms.items()},
         wave_ms=wave_ms, host_ms_per_wave=host_ms,
         max_memory_allocated=peak)
    for mode in ("sq8", "none"):
        rt.quantize = mode
        rt._sq8_bad_streak = 0      # so the sq8 wave runs the SQ8 scan
        profile_wave(vm, qsets[0], patterns, mode)
    return (cap_a.args, launches_a, tiles_a), \
        (cap_b.args, launches_b, tiles_b), cap_call.args, dev_vecs, \
        (vm, vecs, rows_of, patterns)


# --------------------------------------------------------------------- #
# phase 4: unfiltered exact k-NN over the resident table
# --------------------------------------------------------------------- #

Q_UNFILTERED = 128


def _row_lists(vals, ids):
    return [(v, i) for v, i in zip(host(vals), host(ids))]


def phase_unfiltered(table: torch.Tensor):
    """``ops.topk``, ``ops.pairwise_sqdist`` (l2, ip) and
    ``quant.topk_sq8_rerank`` on the resident main-path table, held
    against an fp64 brute force on the card; then each kernel against its
    plain version on the inputs this phase gave it, and timed."""
    from repro_torch.kernels import distance_topk, ops, pairwise, quant
    n, d = table.shape
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, n, Q_UNFILTERED)).to(table.device)
    noise = torch.from_numpy(0.3 * rng.standard_normal(
        (Q_UNFILTERED, d)).astype(np.float32)).to(table.device)
    x = (table[rows] + noise).contiguous()

    call_ms = {}

    def timed(name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        call_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    distance_topk.distance_topk.launches = 0
    pairwise.pairwise_distance.launches = 0
    quant.quantized_topk.launches = 0
    with Capture(ops, "distance_topk") as cap_t, \
            Capture(ops, "pairwise_distance") as cap_p, \
            Capture(quant, "quantized_topk") as cap_q:
        vals, ids = timed("ops.topk", ops.topk, x, table, K)
        d_l2 = timed("ops.pairwise_sqdist_l2", ops.pairwise_sqdist, x, table,
                     metric="l2")
        d_ip = timed("ops.pairwise_sqdist_ip", ops.pairwise_sqdist, x, table,
                     metric="ip")
        sv, si = timed("quant.topk_sq8_rerank", quant.topk_sq8_rerank, x,
                       table, K, overfetch=4)
    launches = {"topk_f32": distance_topk.distance_topk.launches,
                "pairwise_f32": pairwise.pairwise_distance.launches,
                "qtopk_sq8": quant.quantized_topk.launches}
    for name, count in launches.items():
        check(count > 0, f"{name} never launched in the unfiltered phase")

    x64, t64 = x.double(), table.double()
    ip64 = x64 @ t64.T                       # fp64 brute force on the card
    d64 = ((x64 * x64).sum(1, keepdim=True) + (t64 * t64).sum(1)
           - 2.0 * ip64).clamp_min(0.0)
    del t64
    ov, oi = torch.topk(d64, K, dim=1, largest=False)
    recall = recall_check(_row_lists(vals, ids), _row_lists(ov, oi))
    check(recall == 1.0, f"ops.topk recall {recall} < 1.0")
    pw_err = {}
    for name, got, want in [("l2", d_l2, d64), ("ip", d_ip, -ip64)]:
        tol = 1e-4 * float(want.abs().max())
        pw_err[name] = float((got.double() - want).abs().max())
        check(pw_err[name] <= tol,
              f"pairwise {name} differs from fp64 by {pw_err[name]} > {tol}")
    del d64, ip64, d_l2, d_ip
    oi_h, si_h = host(oi), host(si)
    sq8_recall = float(np.mean([len(set(si_h[r]) & set(oi_h[r])) / K
                                for r in range(Q_UNFILTERED)]))
    check(sq8_recall >= 0.9, f"topk_sq8_rerank recall {sq8_recall} < 0.9")
    true = ((table[si.long()].double() - x.double()[:, None]) ** 2).sum(-1)
    rel = float(((sv.double() - true).abs() / true.clamp_min(1.0)).max())
    check(rel <= 1e-4, f"sq8 rerank distances off by {rel} relative")
    emit(phase="unfiltered", q=Q_UNFILTERED, n=n, d=d, k=K,
         recall_topk=recall, recall_sq8_rerank=sq8_recall,
         sq8_rerank_max_rel_err=rel, pairwise_max_abs_err_vs_fp64=pw_err,
         kernel_launches=launches, call_ms=call_ms)
    torch.cuda.empty_cache()

    kernels = [measure_topk_f32(*cap_t.args, launches["topk_f32"]),
               measure_qtopk_sq8(cap_q.args[0], launches["qtopk_sq8"],
                                 call_ms["quant.topk_sq8_rerank"]),
               measure_pairwise_f32(*cap_p.args, launches["pairwise_f32"])]
    torch.cuda.empty_cache()
    return kernels


def measure_topk_f32(args, kwargs, launches):
    from repro_torch.kernels.distance_topk import dense_topk, distance_topk
    x, y, kp = args
    err, tol = check_close_topk(distance_topk, dense_topk, *args, **kwargs)
    ms = cuda_ms(lambda: distance_topk(*args, **kwargs))
    plain_ms = cuda_ms(lambda: dense_topk(*args, **kwargs), reps=3)

    def composition():
        dist = (x * x).sum(1, keepdim=True) + (y * y).sum(1) - 2.0 * (x @ y.T)
        return torch.topk(dist, kp, dim=1, largest=False)

    comp_ms = cuda_ms(composition, reps=3)
    q, d = x.shape
    n = y.shape[0]
    bound_ms, bound_by = _bound((q + n) * d * 4 + q * kp * 8, 2 * q * n * d,
                                PEAK_F32)
    return {"name": "topk_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_seg.cu",
            "replaces": "src/repro/kernels/distance_topk.py:62",
            "launches": launches, "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call ranks distances",
            "composition_ms": comp_ms,
            "tflops": 2 * q * n * d / ms / 1e9,
            "shape": {"Q": q, "N": n, "d": d, "kp": kp, **kwargs}}


def measure_qtopk_sq8(args, launches, call_ms):
    from repro_torch.kernels.quant import quantized_topk, sq8_dense
    from repro_torch.kernels.tuning import SQ8_TILE, select_sq8_splits
    xq, sx, x2, yq, sy, y2, kqp = args
    err = check_bit_equal(quantized_topk, sq8_dense, *args)
    ms = cuda_ms(lambda: quantized_topk(*args))
    plain_ms = cuda_ms(lambda: sq8_dense(*args), reps=3)

    def composition():
        dot = xq.float() @ yq.float().T         # exact: d·127² < 2²⁴
        dist = ((x2[:, None] + y2[None, :])
                - 2.0 * (dot * sx[:, None]) * sy[None, :])
        return torch.topk(dist.clamp_min(0.0), kqp, dim=1, largest=False)

    comp_ms = cuda_ms(composition, reps=3)
    mm_ms = int_mm_ms(xq, yq)
    q, d = xq.shape
    n = yq.shape[0]
    bytes_ = (q + n) * (d + 8) + q * kqp * 8
    bound_ms, bound_by = _bound(bytes_, 2 * q * n * d, PEAK_INT8)
    return {"name": "qtopk_sq8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/qtopk_seg.cu",
            "replaces": "src/repro/kernels/quant.py:86",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call ranks distances",
            "composition_ms": comp_ms, "int_mm_ms": mm_ms,
            "achieved_gbps": bytes_ / ms / 1e6,
            "computed_tops": 2 * q * n * d / ms / 1e9,
            "topk_sq8_rerank_call_ms": call_ms,
            "shape": {"Q": q, "N": n, "d": d, "kqp": kqp,
                      "tiles": SQ8_TILE,
                      "splits": select_sq8_splits(q, n, *SQ8_TILE, k=kqp)}}


def measure_pairwise_f32(args, kwargs, launches):
    """Timed on the ``ip`` call the phase made last (one ``torch.addmm``
    computes the same −x·yᵀ); the ``l2`` call beside it."""
    from repro_torch.kernels.distance_topk import dense_distance
    from repro_torch.kernels.pairwise import pairwise_distance
    x, y = args
    q, d = x.shape
    n = y.shape[0]
    out = {}
    for metric in ("ip", "l2"):
        kw = dict(kwargs, metric=metric)
        err, tol = check_pairwise(x, y, **kw)
        out[metric] = {
            "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(lambda: pairwise_distance(x, y, **kw)),
            "plain_ms": cuda_ms(lambda: dense_distance(x, y, **kw), reps=3)}
    x2 = (x * x).sum(1, keepdim=True)
    y2 = (y * y).sum(1)
    out["l2"]["composition_ms"] = cuda_ms(lambda: torch.addmm(
        x2 + y2, x, y.T, beta=1, alpha=-2).clamp_min_(0.0), reps=3)
    dest = torch.empty((q, n), dtype=torch.float32, device=x.device)
    library_ms = cuda_ms(lambda: torch.addmm(dest, x, y.T, beta=0,
                                             alpha=-1), reps=3)
    del dest
    bound_ms, bound_by = _bound((q + n) * d * 4 + q * n * 4, 2 * q * n * d,
                                PEAK_F32)
    return {"name": "pairwise_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pairwise.cu",
            "replaces": "src/repro/kernels/pairwise.py:28",
            "launches": launches, "metric": "ip",
            "max_abs_err": out["ip"]["max_abs_err"], "tol": out["ip"]["tol"],
            "ms": out["ip"]["ms"], "plain_ms": out["ip"]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "torch.addmm(out, x, y.T, beta=0, alpha=-1)",
            "composition_ms": None, "l2": out["l2"],
            "tflops": 2 * q * n * d / out["ip"]["ms"] / 1e9,
            "library_tflops": 2 * q * n * d / library_ms / 1e9,
            "shape": {"Q": q, "N": n, "d": d, "accum": kwargs.get(
                "accum", "f32")}}


# host calls that block on the device: the runtime's waits and copies,
# and ``aten::_local_scalar_dense`` (a tensor read as a Python scalar,
# e.g. the SQ8 certificate's ``bool(cert.all())``)
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaMemcpy",
            "aten::_local_scalar_dense")


def device_profile(fn, blocking=None):
    """``fn()`` once under ``torch.profiler``: (wall ms, device busy ms or
    None when the trace holds no device time, the top 8 device kernels
    by time).  With ``blocking`` (a dict), it also receives the host
    time and count of each ``BLOCKING`` call and of kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if blocking is not None and (e.key in BLOCKING
                                     or e.key == "cudaLaunchKernel"):
            blocking[e.key] = {"ms": e.cpu_time_total / 1e3,
                               "count": e.count}
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                # host ops would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) if rows else None   # None: no trace
    return wall_ms, busy, [{"kernel": k[:80], "ms": ms, "count": c}
                           for ms, k, c in rows[:8]]


def profile_wave(vm, queries, patterns, mode: str) -> None:
    """One wave under ``torch.profiler``: device time by kernel name and
    the device's busy share of the wave's wall time.  Run after the
    counted waves, so its launches count nowhere."""
    blocked = {}
    wall_ms, busy, top = device_profile(
        lambda: vm.query_batch(queries, patterns, K), blocked)
    emit(phase="profile", mode=mode, wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=None if busy is None else 1 - busy / wall_ms,
         top=top, host_blocked=blocked)


# --------------------------------------------------------------------- #
# phase 5: serving — checkpoint/restore, one stream twice, kill/rejoin
# --------------------------------------------------------------------- #

SERVE_WAVES = 32            # read waves of the stream
SERVE_SEGMENT = 8           # read waves between write bursts
SERVE_INSERTS = 10          # inserts per write burst
SERVE_DELETES = 60          # deletes per write burst


class FakeClock:
    """The router's liveness clock, advanced by the script (heartbeat
    verdicts replay identically whatever the card's speed)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def new_scale_records(start: int, count: int, dim: int):
    """Records ``start .. start+count-1`` of ``make_scale_corpus``'s
    generator: new records past a table of ``start`` rows."""
    from repro_torch.data.corpora import scale_sequences, stream_scale_vectors
    blocks = [(s0, blk) for s0, blk in stream_scale_vectors(start + count,
                                                            dim)
              if s0 + len(blk) > start]
    vecs = np.concatenate([blk for _, blk in blocks])
    lo = start - blocks[0][0]
    return vecs[lo:lo + count], scale_sequences(start + count)[start:]


def _snap_rows(res):
    """(ids, distances rounded to 5 decimals) per request."""
    return [(i.tolist(), np.round(d, 5).tolist()) for d, i in res]


def _ckpt_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def build_stream(vecs, ins_vecs, ins_seqs, rng):
    """The scripted stream: ``SERVE_WAVES`` read waves of 64 requests in
    segments of ``SERVE_SEGMENT`` waves; before every segment but the
    first, a write burst (inserts of the new records, deletes of live
    base ids), and a forced compaction before the third segment."""
    n, dim = vecs.shape
    n_bursts = SERVE_WAVES // SERVE_SEGMENT - 1
    victims = rng.choice(n, n_bursts * SERVE_DELETES, replace=False)
    segments = []
    for s in range(SERVE_WAVES // SERVE_SEGMENT):
        writes = []
        if s:
            b = s - 1
            for j in range(b * SERVE_INSERTS, (b + 1) * SERVE_INSERTS):
                writes.append(("insert", ins_vecs[j], ins_seqs[j]))
            for vid in victims[b * SERVE_DELETES:(b + 1) * SERVE_DELETES]:
                writes.append(("delete", int(vid)))
            if s == 2:
                writes.append(("compact",))
        waves = [(vecs[rng.integers(0, n, 64)]
                  + 0.3 * rng.standard_normal((64, dim))).astype(np.float32)
                 for _ in range(SERVE_SEGMENT)]
        segments.append((writes, waves))
    return segments


def stream_oracle(vecs, rows_of, patterns, segments, ins_vecs, ins_seqs):
    """Brute-force answers on the card for every read wave: each segment
    sees the base plus the inserts so far, minus the deletes so far."""
    n = len(vecs)
    table = torch.from_numpy(np.concatenate([vecs, ins_vecs])).cuda()
    new_rows = matching_rows(ins_seqs, patterns)
    out, n_ins, gone = [], 0, set()
    for writes, waves in segments:
        for w in writes:
            if w[0] == "insert":
                n_ins += 1
            elif w[0] == "delete":
                gone.add(w[1])
        dead = np.fromiter(gone, np.int64, len(gone))
        live = {p: np.concatenate([
                    rows[~np.isin(rows, dead)],
                    n + new_rows[p][new_rows[p] < n_ins]])
                for p, rows in rows_of.items()}
        out.extend(brute_force(table, live, q, patterns, K) for q in waves)
    del table
    torch.cuda.empty_cache()
    return out


def run_stream(ckpt, quantize, pipeline, patterns, segments):
    """Serve the scripted stream through ``ContinuousBatcher`` on an
    engine restored from ``ckpt``: per-wave results, the read waves'
    wall time (QPS; each write burst lands at a barrier and is timed
    apart), wave completion intervals, launch counts, pipeline counters
    and the device-busy share of 8 warm read waves under the
    profiler."""
    from repro_torch.kernels import distance_topk, ops, quant
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.engine import Request, RetrievalEngine

    eng = RetrievalEngine.restore(ckpt, device="cuda")
    eng.index.config.quantize = quantize
    eng.query_batch(segments[0][1][0], patterns, K)   # upload + warm-up
    torch.cuda.synchronize()
    done_at = []
    stage_s = {"plan": [], "dispatch": [], "fetch": []}

    def timed(stage, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter()
            stage_s[stage].append(t1 - t0)
            if stage == "fetch":
                done_at.append(t1)
            return out
        return call

    for stage in stage_s:                 # the engine's three stages
        name = f"{stage}_batch"
        setattr(eng, name, timed(stage, getattr(eng, name)))
    b = ContinuousBatcher(eng, budget=10 ** 9, max_wave=64,
                          pipeline=pipeline)
    ops.reset_launch_stats()
    distance_topk.topk_seg_f32.launches = 0
    quant.qtopk_seg_sq8.launches = 0
    results, intervals, wall, write_s = [], [], 0.0, 0.0
    read_stage_s = {k: [] for k in stage_s}
    try:
        for writes, waves in segments:
            for w in writes:
                if w[0] == "insert":
                    b.submit_insert(w[1], w[2])
                elif w[0] == "delete":
                    b.submit_delete(w[1])
                else:
                    b.submit_compact()
            t0 = time.perf_counter()
            b.drain()                   # the burst lands at a barrier
            write_s += time.perf_counter() - t0
            tickets = [[b.submit(Request(vector=v, pattern=p, k=K))
                        for v, p in zip(q, patterns)] for q in waves]
            start = len(done_at)
            before = {k: len(v) for k, v in stage_s.items()}
            t0 = time.perf_counter()
            res = b.drain()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            for k, v in stage_s.items():
                read_stage_s[k] += v[before[k]:]
            intervals += np.diff(done_at[start:]).tolist()
            results += [[(res[t].distances, res[t].ids) for t in ts]
                        for ts in tickets]
        launches = {"topk_seg_f32": distance_topk.topk_seg_f32.launches,
                    "qtopk_seg_sq8": quant.qtopk_seg_sq8.launches,
                    **ops.launch_stats()}
        stats = b.maintenance_stats()
        warm = segments[-1][1]
        for q in warm:
            for v, p in zip(q, patterns):
                b.submit(Request(vector=v, pattern=p, k=K))
        blocked = {}
        wall_ms, busy, top = device_profile(b.drain, blocked)
    finally:
        b.close()
    reads = SERVE_WAVES * len(patterns)
    line = {
        "quantize": quantize, "pipeline": pipeline,
        "qps": reads / wall, "reads_s": wall, "writes_s": write_s,
        "wave_ms_p50": float(np.median(intervals)) * 1e3,
        "wave_ms_p25_p75": (np.percentile(intervals, [25, 75]) * 1e3
                            ).tolist(),
        "stage_ms_p50": {k: float(np.median(v)) * 1e3
                         for k, v in read_stage_s.items()},
        "stage_ms_mean": {k: float(np.mean(v)) * 1e3
                          for k, v in read_stage_s.items()},
        "launches_per_wave": {k: v / SERVE_WAVES
                              for k, v in launches.items()},
        "pipeline_counters": {k: v for k, v in stats.items()
                              if k.startswith(("pipeline_", "staging_",
                                               "device_idle",
                                               "planner_wait"))},
        "writes_applied": b.writes_applied,
        "sq8_stats": {k: v for k, v in stats.items()
                      if k.startswith("sq8_")},
        "host_ms": {k: v for k, v in stats.items() if k.startswith("time_")},
        "window": {"waves": len(warm), "wall_ms": wall_ms,
                   "device_busy_ms": busy,
                   "qps": len(warm) * len(patterns) / wall_ms * 1e3,
                   "device_busy_share": None if busy is None
                   else busy / wall_ms, "top": top[:4],
                   "host_blocked": blocked}}
    del eng, b
    torch.cuda.empty_cache()
    return results, launches, line


def kill_and_rejoin(ckpt, tmp, patterns, vecs, ins_vecs, ins_seqs, rng):
    """A 2-replica set attached to an engine restored from ``ckpt``,
    behind a router; r1 is killed at wave 4 mid-churn and rejoins at wave
    9 from the attach checkpoint plus a replay of the log.  Every answer
    must equal a single-replica oracle's."""
    from repro_torch.distributed.replication import (FaultInjector,
                                                     ReplicaSet)
    from repro_torch.serve.engine import RetrievalEngine
    from repro_torch.serve.router import ReplicatedRouter

    n, dim = vecs.shape
    leader = RetrievalEngine.restore(ckpt, device="cuda")
    oracle = RetrievalEngine.restore(ckpt, device="cuda")
    t0 = time.perf_counter()
    rs = ReplicaSet.from_engine(leader, n_replicas=2,
                                ckpt_dir=str(Path(tmp) / "replicas"))
    attach_s = time.perf_counter() - t0
    clk = FakeClock()
    inj = FaultInjector()
    inj.kill("r1", at_wave=4)
    inj.rejoin("r1", at_wave=9)
    router = ReplicatedRouter(rs, heartbeat_timeout_s=5.0, clock=clk,
                              sleep=clk.sleep, injector=inj)
    rejoin_s = []
    rejoin = router.rejoin

    def timed_rejoin(name, devices=None):
        t1 = time.perf_counter()
        r = rejoin(name, devices=devices)
        rejoin_s.append(time.perf_counter() - t1)
        return r

    router.rejoin = timed_rejoin
    waves = 12
    victims = iter(rng.choice(n, waves, replace=False).tolist())
    bit_exact = answers = 0
    t0 = time.perf_counter()
    for w in range(waves):
        vid = router.submit_insert(ins_vecs[w], ins_seqs[w])
        check(vid == oracle.insert(ins_vecs[w], ins_seqs[w]),
              f"insert id {vid} differs from the oracle's")
        if w % 3 == 1:
            victim = next(victims)
            router.submit_delete(victim)
            oracle.delete(victim)
        if w == 6:
            router.submit_compact()
            oracle.compact()
        q = (vecs[rng.integers(0, n, 64)]
             + 0.3 * rng.standard_normal((64, dim))).astype(np.float32)
        got = router.serve_wave(q, patterns, K)
        want = oracle.query_batch(q, patterns, K)
        check(_snap_rows(got) == _snap_rows(want),
              f"replicated answers differ from the oracle's at wave {w}")
        bit_exact += sum(np.array_equal(gd, wd) and np.array_equal(gi, wi)
                         for (gd, gi), (wd, wi) in zip(got, want))
        answers += len(got)
        clk.t += 2.0
    churn_s = time.perf_counter() - t0
    router.assert_no_loss()
    st = router.router_stats()
    check(st["accepted"] == st["answered"] == waves,
          f"router accepted {st['accepted']}, answered {st['answered']}")
    check(st["rejoined"] == 1 and len(rejoin_s) == 1, "r1 did not rejoin")
    check(st["failovers"] >= 1, "the kill was never observed")
    check(("kill", 4, "r1") in inj.events, "the kill did not fire")
    r1 = rs.replicas["r1"]
    check(r1.alive and r1.serving and rs.lag(r1) == 0,
          "the rejoined replica is not serving at the watermark")
    out = {"replicas": 2, "waves": waves, "requests": answers,
           "attach_s": attach_s, "rejoin_s": rejoin_s[0],
           "churn_s": churn_s, "answers_bit_exact": bit_exact,
           "router": {k: st[k] for k in
                      ("accepted", "answered", "failovers", "retries",
                       "ejected", "rejoined", "commit_lsn")},
           "events": [list(e) for e in inj.events]}
    del leader, oracle, rs, router
    torch.cuda.empty_cache()
    return out


def phase_serving(vm, vecs, rows_of, patterns) -> None:
    """The serving tier on the main path's 1,048,576 × 128 index: (a)
    checkpoint and restore, (b) one scripted stream through the
    synchronous and the pipelined ``ContinuousBatcher`` under ``sq8``
    and ``none``, (c) kill and rejoin a replica behind the router."""
    import tempfile

    from repro_torch.kernels import distance_topk, quant
    from repro_torch.serve.engine import RetrievalEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory(prefix="serving_") as tmp:
        # (a) checkpoint and restore
        ckpt = str(Path(tmp) / "index")
        t0 = time.perf_counter()
        vm.save(ckpt)
        save_s = time.perf_counter() - t0
        q = (vecs[rng.integers(0, len(vecs), 64)]
             + 0.3 * rng.standard_normal((64, vecs.shape[1]))).astype(
            np.float32)
        vm.runtime.quantize = "sq8"
        t0 = time.perf_counter()
        eng = RetrievalEngine.restore(ckpt, device="cuda")
        got = eng.query_batch(q, patterns, K)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        check(_snap_rows(got) == _snap_rows(vm.query_batch(q, patterns, K)),
              "the restored engine answers differently")
        emit(phase="serving_checkpoint", bytes=_ckpt_bytes(ckpt),
             save_s=save_s, restore_to_first_wave_s=recover_s,
             files=sorted(p.name for p in Path(ckpt).iterdir()))
        del eng
        torch.cuda.empty_cache()

        # (b) one stream, served twice, under each scan
        n_bursts = SERVE_WAVES // SERVE_SEGMENT - 1
        ins_vecs, ins_seqs = new_scale_records(
            len(vecs), n_bursts * SERVE_INSERTS, vecs.shape[1])
        segments = build_stream(vecs, ins_vecs, ins_seqs, rng)
        oracle = stream_oracle(vecs, rows_of, patterns, segments,
                               ins_vecs, ins_seqs)
        distance_topk.topk_seg_f32.launches = 0
        quant.qtopk_seg_sq8.launches = 0
        lines = []
        for quantize in ("sq8", "none"):
            # in turns — sync, pipelined, pipelined, sync — so the two
            # modes are compared within one call on one card
            runs = [(mode, run_stream(ckpt, quantize, mode, patterns,
                                      segments))
                    for mode in (False, True, True, False)]
            res_s, la_s, _ = runs[0][1]
            for w in range(SERVE_WAVES):
                rec = recall_check(res_s[w], oracle[w])
                check(rec == 1.0, f"recall {rec} < 1.0 ({quantize}, "
                      f"wave {w})")
            for turn, (mode, (res, la, line)) in enumerate(runs):
                for w in range(SERVE_WAVES):
                    check(_snap_rows(res[w]) == _snap_rows(res_s[w]),
                          f"wave {w} of turn {turn} differs from the sync "
                          f"oracle ({quantize})")
                check(la == la_s, f"launches differ between turns "
                      f"({quantize}): {la_s} vs {la}")
                check(not mode or line["pipeline_counters"].get(
                    "pipeline_waves", 0) >= SERVE_WAVES,
                      "the pipelined run did not pipeline")
                line.update(turn=turn, recall=1.0)
                emit(phase="serving_stream", **line)
                lines.append(line)
        check(sum(line["launches_per_wave"]["qtopk_seg_sq8"]
                  for line in lines) > 0,
              "kernel B never launched in the serving phase")
        check(sum(line["launches_per_wave"]["topk_seg_f32"]
                  for line in lines) > 0,
              "kernel A never launched in the serving phase")
        del oracle

        # (c) kill a replica mid-churn and rejoin it
        out = kill_and_rejoin(ckpt, tmp, patterns, vecs, ins_vecs,
                              ins_seqs, rng)
        emit(phase="serving_replicas", **out)
    summary = {}
    for line in lines:
        name = (f"{line['quantize']}/"
                f"{'pipelined' if line['pipeline'] else 'sync'}")
        summary.setdefault(name, {"qps": [], "wave_ms_p50": [],
                                  "device_busy_share": []})
        summary[name]["qps"].append(line["qps"])
        summary[name]["wave_ms_p50"].append(line["wave_ms_p50"])
        summary[name]["device_busy_share"].append(
            line["window"]["device_busy_share"])
    emit(phase="serving_done", seconds=time.perf_counter() - t_phase,
         turns=summary)


# --------------------------------------------------------------------- #
# phase 6: graph states, churn and compaction
# --------------------------------------------------------------------- #

def _graph_free_requests(vm, patterns):
    plan = vm.plan(patterns)
    free = set(range(len(patterns))) - set(plan.misses)
    for e in plan.entries:
        if any(s.graph_states for s in e.sources):
            free -= set(e.requests)
    return sorted(free)


def phase_graphs() -> None:
    from repro_torch.core.predicate import as_predicate
    from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
    from repro_torch.data.corpora import make_corpus, sample_patterns

    vecs, seqs = make_corpus("code")
    cfg = dict(T=50, M=8, ef_con=60, auto_compact=False)
    t0 = time.perf_counter()
    vms = {"cuda": VectorMaton(vecs, seqs, VectorMatonConfig(
               device="cuda", **cfg)),
           "cpu": VectorMaton(vecs, seqs, VectorMatonConfig(
               device="cpu", **cfg)),
           "numpy": VectorMaton(vecs, seqs, VectorMatonConfig(
               backend="numpy", **cfg))}
    build_s = time.perf_counter() - t0
    n_graphs = len(vms["cuda"].runtime.graphs)
    check(n_graphs > 0, "the code corpus built no graph states")
    rng = np.random.default_rng(2)
    patterns = (sample_patterns(seqs, 2, 32, seed=1)
                + sample_patterns(seqs, 1, 32, seed=2))
    live_seqs = list(seqs)

    def wave(name):
        q = rng.standard_normal((len(patterns), vecs.shape[1])).astype(
            np.float32)
        t0 = time.perf_counter()
        res = {b: vm.query_batch(q, patterns, K) for b, vm in vms.items()}
        dt = time.perf_counter() - t0
        free = _graph_free_requests(vms["cuda"], patterns)
        table = vms["cuda"].vectors
        deleted = vms["cuda"].deleted
        for r, p in enumerate(patterns):
            (d, i), (dc, ic) = res["cuda"][r], res["cpu"][r]
            check(len(i) == len(ic), f"{name} {p!r}: {len(i)} vs {len(ic)}")
            if len(i):
                topk_agree(d[None], i[None], dc[None], ic[None], 2e-4)
            if r in free:
                dn, inp = res["numpy"][r]
                check(len(i) == len(inp), f"{name} {p!r}: vs numpy")
                if len(i):
                    topk_agree(d[None], i[None], dn[None], inp[None], 2e-4)
            pred = as_predicate(p)
            for dist, gid in zip(d, i):
                check(int(gid) not in deleted, f"{name}: deleted id {gid}")
                check(pred.matches(live_seqs[int(gid)]),
                      f"{name}: id {gid} fails {p!r}")
                true = float(((table[gid] - q[r]) ** 2).sum())
                check(abs(true - float(dist)) <= 2e-4 * max(true, 1.0),
                      f"{name}: id {gid} distance {dist} vs {true}")
        emit(phase="graphs", wave=name, requests=len(patterns),
             graph_free=len(free), deleted=len(deleted),
             seconds_all_backends=dt)

    wave("frozen")
    for _ in range(40):                      # past the upload watermark
        j = int(rng.integers(0, len(seqs)))
        v = (vecs[j] + 0.1 * rng.standard_normal(vecs.shape[1])).astype(
            np.float32)
        for vm in vms.values():
            vm.insert(v, seqs[j])
        live_seqs.append(seqs[j])
    wave("inserts")
    for gid in rng.choice(len(seqs), 30, replace=False):
        for vm in vms.values():
            vm.delete(int(gid))
    wave("deletes_overfetch")
    for gid in rng.choice(len(seqs), 120, replace=False):
        for vm in vms.values():
            vm.delete(int(gid))
    wave("deletes_bitmap")
    for vm in vms.values():
        vm.compact()
    wave("compacted")
    stats = {b: vm.maintenance_stats() for b, vm in vms.items()}
    check(set(stats["cuda"]) == set(stats["cpu"]) == set(stats["numpy"]),
          "maintenance_stats keys differ across backends")
    emit(phase="graphs_done", graph_states=n_graphs, build_s=build_s,
         compactions=stats["cuda"]["compactions"],
         launch_graph_fused=stats["cuda"].get("launch_graph_fused", 0),
         launch_graph_fused_filt=stats["cuda"].get(
             "launch_graph_fused_filt", 0))
    # after the counted waves, one wave on the card under the profiler:
    # what the beam's every-16-steps convergence check (``bool(active.
    # any())``, under ``aten::_local_scalar_dense``) and the copies cost
    # the host
    blocked = {}
    q = rng.standard_normal((len(patterns), vecs.shape[1])).astype(
        np.float32)
    wall_ms, busy, top = device_profile(
        lambda: vms["cuda"].query_batch(q, patterns, K), blocked)
    emit(phase="graphs_profile", wall_ms=wall_ms, device_busy_ms=busy,
         top=top[:4], host_blocked=blocked)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="card", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    t_start = time.perf_counter()
    phase_build()
    if PHASES is not None:
        if "edges" in PHASES:
            phase_edges()
        emit(phase="done", partial=sorted(PHASES),
             seconds=time.perf_counter() - t_start)
        return 0
    phase_edges()
    (args_a, launches_a, tiles_a), (args_b, launches_b, tiles_b), call, \
        table, serving_inputs = phase_main_path()
    kernels = [measure_kernel_a(*args_a, launches_a, tiles_a),
               measure_kernel_b(args_b[0], launches_b, tiles_b)]
    del args_a, args_b
    torch.cuda.empty_cache()
    kernels[1]["sq8_call"] = measure_sq8_call(call)
    del call
    torch.cuda.empty_cache()
    kernels += phase_unfiltered(table)
    del table
    torch.cuda.empty_cache()
    phase_serving(*serving_inputs)
    del serving_inputs
    torch.cuda.empty_cache()
    phase_graphs()
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


PHASES = None           # None: every phase; else a subset (see --phases)

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        PHASES = set(sys.argv[2].split(","))
        check(PHASES <= {"build", "edges"},
              f"--phases takes build and edges, not {sorted(PHASES)}")
    elif len(sys.argv) != 1:
        sys.exit("usage: chip_smoke.py [--phases build,edges]")
    sys.exit(main())

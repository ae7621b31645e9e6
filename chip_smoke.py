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
     97 and a misaligned base (4-byte copies), d = 100, 768 and 2,560 (the
     LM's width, kernels A and B under three owner layouts), Q = 1 and
     129, SQ8 at d = 4096, 8 and 130, Q = 1024 × N = 65,536 × d = 768
     for the unsegmented kernels, and kernels A and B (B at kqp = 8, 40
     and 128) under every owner layout of their tile skip:
     owner-sorted descriptor and tail runs, random owners, scattered
     tombstones, pad rows, an owner with no candidates, negative owners
     that match, ragged Q): the SQ8 kernels must be bit-equal to their
     plain versions, the fp32 ones within atol 1e-4·max|d| on values and
     equal on ids except where the distance is within that tolerance of a
     neighbour's; kernels A and B must compute exactly the (row tile,
     column tile) pairs that the plain skip rule keeps;
  3. the LM, first part (before the index phases): ``lm_model`` —
     qwen3-4b at its published width and depth in bf16, random weights
     from a seeded generator on the card (parameters against
     ``cfg.param_count()``, device bytes, init seconds); ``lm_parity`` —
     the card against the port's own CPU path on the same weights: the
     full-width config cut to 2 layers (hidden states of 4 × 96 tokens
     within 2e-2·max|h|) and every architecture's smoke config in fp32
     (prefill + 8 greedy decode steps, logits within 1e-3·max|logit|,
     tokens equal but at near ties); ``lm_embed`` — ``embed_texts`` over
     the 3,000 records of ``make_corpus("mtg")`` (96 byte tokens each,
     batches of 64): tokens/s, ms a batch, peak memory, the norms of the
     embeddings; ``lm_generate`` — 8 prompts of 128 tokens, one prefill
     and 32 greedy decode steps (``make_prefill`` / ``make_decode``):
     prefill ms, decode ms a token (p50), and the tokens at steps 0, 1,
     16 and 32 held to the argmax of a full-sequence ``forward`` (near
     ties within 2e-2·max|logit|);
  4. the main path at SIFT1M shape — ``make_scale_corpus(1_048_576, 128)``
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
  5. unfiltered — the same resident 1,048,576 × 128 table through the
     unsegmented exact k-NN entry points, Q = 128 queries, k = 10:
     ``ops.topk`` (recall 1.0 against an fp64 brute force on the card),
     ``ops.pairwise_sqdist`` (l2 and ip, within 1e-4·max|d| of fp64) and
     ``quant.topk_sq8_rerank(overfetch=4)`` (recall ≥ 0.9, every distance
     the fp32 distance of its row); the three kernels' launch counters
     must move, and each is held against its plain version on the inputs
     the phase gave it and timed beside its plain version, the torch
     composition, the one PyTorch call where there is one, and its bound;
     ``topk_f32`` also under the other tile and split choices
     (``ms_by_policy``) and at Q = 1024 × N = 65,536 × d = 768
     (``bench_max``), with its ptxas registers and spills;
  5b. beam — ``beam_f32`` (``csrc/beam.cu``, the fused HNSW beam)
     against its plain version ``hnsw_torch._beam`` on the same table:
     level-0 lists of each node's 32 exact nearest neighbours
     (``ops.topk``) within 8 graphs of 131,072 nodes (one bucket, 64
     queries against each: P = 512, visited bitmaps in shared memory)
     and within one graph of all 1,048,576 nodes (each node's last edge
     to a random node of another eighth; P = 64, bitmaps in device
     memory); ef = 64, k = 10, l2 and ip, unfiltered and under masks
     allowing 10 % and 50 % of ids; integer-valued vectors bit-equal to
     the plain version, float vectors ≥ 99 % of pairs the same ids and
     recall@10 ≥ 0.995 against it; distances within 1e-5 of an fp32
     recomputation, ids allowed by their masks;
     the float cases timed beside the plain version and the byte bound
     (visited nodes and steps from the kernel's optional outputs), the
     longest pair's steps, µs a step and its clock64() cycles by phase,
     and the neighbour tables' bytes; then the shapes past the old
     kernel's limits on a graph of 4,096 nodes (ef = 1,040 with 2M = 33,
     2M = 130 with ef = 64), integer-valued, bit-equal to the plain
     version, with the ef-list in shared and in device memory, timed;
     with a parent checkout unpacked at ``build/parent`` every timed case
     also times the parent's ``beam_f32`` (parent, change, change,
     parent), built from its own sources;
  6. serving, on the main path's index (not rebuilt): (a) checkpoint it
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
  7. sharded, on the same index split into 4 logical row shards on the
     card (``make_host_mesh(data=4)``): the residency build (seconds,
     device bytes); 16 waves per mode through ``sharded_plan_topk``,
     each equal to the one-device ``query_batch`` under ``topk_agree``
     and at recall 1.0 against brute force, timed beside it, with
     kernels A and B launched per shard (counted) and one profiled wave;
     kernels A and B held against their plain versions at a shard's
     shape and timed; the same waves through ``RetrievalEngine(mesh=)``
     restored from a checkpoint; 10 inserts and 60 resident deletes past
     the residency, a compaction, and a restore of the compacted engine
     onto the 2-shard mesh ``ElasticPlan.remesh`` picks over 3 devices,
     each held to brute force; ``sharded_topk`` under a mask against
     ``ops.topk`` on the masked rows;
  8. graph states, inserts past the upload watermark, deletes and one
     compaction on ``make_corpus("code")`` with ``T=50, M=8, ef_con=60``
     (built once on the host; the card's and the CPU's executors load it
     from its checkpoint): every wave equals the same index run through
     the port's plain
     PyTorch path on the CPU (near ties aside), graph-free requests equal
     the NumPy host oracle, and every answer is a live record that
     satisfies its predicate at its true distance; every beam call of
     the card's executor launched ``beam_f32`` once (its counter against
     the executor's fused, filtered and per-state beam calls); then one
     profiled wave (``graphs_profile``: one ``beam_f32`` kernel a beam
     call, no blocking host call inside the beam's range, and the bound
     from the kernel's visited and step counts), and its beam calls
     launched again and timed (``beam_replay``; beside the parent's
     kernel when ``build/parent`` holds one), with each wrapper's host
     work a call (time to return, aten ops, Python calls), and again on
     integer data of their shapes, bit-equal to the plain version;
  9. the LM, second part: a child process builds the index of the
     embeddings on the host (``T=40, M=8, ef_con=50``, the example's tag
     and price attributes; about 4 minutes of Python HNSW work) from the
     end of the sharded phase on, so it overlaps the graphs phase and
     none of the host-bound times above; ``lm_index`` — that index
     restored onto the card (build and restore seconds, graph states);
     ``lm_serve`` — ``pattern_search.py``'s request sets (120 CONTAINS,
     11 boolean/LIKE, 9 tag + range) through ``serve_batch`` under
     ``sq8`` and ``none``: every id satisfies its predicate, graph-free
     requests equal a brute force on the card (recall 1.0), the mean
     recall@10 of the graph-state CONTAINS requests against the host
     oracle, kernels A and B launched (counted), every beam call of the
     phase one ``beam_f32`` launch, and a checkpoint
     restored with identical answers; the request sets' beam calls
     recorded and run again on integer data of their shapes (d = 2,560,
     float4 loads, the query in shared and in device memory; d = 2,559,
     scalar loads), each bit-equal to the plain version; ``lm_kernels`` — kernels A and B
     held against their plain versions at this phase's shape (d = 2,560)
     and timed beside them and their bounds; ``lm_generate_profile`` —
     one decode step under ``torch.profiler`` (last: a traced process
     launches more slowly afterwards);
  10. the ``kernels`` line (kernels A and B with their launches and
     times in the sharded and LM phases too; ``beam_f32`` with the
     graphs phase's launches and the LM's); 11. the card line and the
     ``ok`` line.

Between the LM's first part and the main path run the training phases
(no kernel of the port runs in them; the reference's models and train
step have no ``pallas_call``):
  T1. ``train_parity`` — the card against the port's own CPU path on the
     same weights: qwen3-4b at full width cut to 2 layers in bf16, 4 × 96
     tokens (the loss within 1e-3 relative, the global grad norm and
     every leaf's gradient within 2⁻⁵·max|g| of the leaf: four bf16 ulps
     of its largest element — the CPU widens the operands, the card
     rounds each GEMM's cotangent to bf16, and the two sum bf16 values
     in other orders), and every
     architecture's smoke config in fp32, one full train step (the loss
     within 1e-4 relative, the parameters under the Adam rule: elements
     whose CPU gradient exceeds 1e-4·max|g| of their leaf within rtol
     1e-5 + atol 1e-6, the others within 2·lr);
  T2. ``train_full`` — ``repro_torch.launch.train --arch qwen3-4b --steps
     10 --batch 8 --seq 128`` (bf16, remat) in a spawned process: the
     loss and grad norm of every step (finite; every leaf changed), step
     ms p50 over steps 3–10, tokens/s, model TFLOP/s (6 · parameters ·
     tokens plus attention) and its share of the 989 TFLOP/s bf16 peak
     (``mfu``), peak memory, the optimizer update's ms (CUDA events) and
     its bound, and one more step under the profiler: kernels a step,
     busy share, the top device kernels;
  T3. ``train_embedder`` — ``examples/train_embedder.py`` at its own
     size (mamba2-370m cut to 12 layers, vocab 8,192, fp32, chunk 64),
     150 steps of 8 × 128: the loss must drop; async checkpoints at 50
     and 100 and a final one (bytes, seconds); a restore and one more
     step; 3 steps + checkpoint + restore + 3 against 6 uninterrupted
     (atol 1e-5 + rtol 1e-4).

After the LM's second part — past every phase whose host times are
reported — run the data-parallel phases (no kernel of the port runs in
them either):
  D1. ``train_dp_parity`` — qwen3-4b and qwen3-moe-30b-a3b at their
     published widths cut to 2 layers, bf16, 8 × 128 tokens: one step
     over ``make_host_mesh(data=2)`` and ``(data=4)`` (batch shards on
     the card, one replica) against the one-device step from the same
     weights and batch: loss and MoE aux loss within 1e-3 relative, the
     grad norm within 2⁻⁵ relative, every leaf's gradient within
     2⁻⁵·max|g| (``train_parity``'s tolerances: the shards' GEMMs round
     differently, and the shards' bf16 gradients are summed in bf16),
     the updated parameters under the Adam rule at bf16
     width;
  D2. ``train_dp_full`` — ``train_full``'s run through
     ``launch.train.run(args, mesh=make_host_mesh(data=2))`` with
     ``--placement replicated`` in a
     spawned process: step ms p50, tokens/s, ``mfu`` and peak memory
     (under 80 GB) beside ``train_full``'s from the same run; the first
     two steps' losses within 1e-3 and 2e-2 relative of its;
  D3. ``psum`` — ``compressed_psum`` over 4 logical shards of a
     151,936 × 2,560 fp32 gradient: bit-equal to the CPU's, within
     8·scale of the exact sum, its ms beside a plain fp32 sum's and
     ``all_reduce_mean``'s.

The FSDP phases (the reference launcher's placement: parameters and
AdamW moments cut over the data axis by the spec tables; no kernel of
the port runs in them either) run between the graphs phase and the
LM's second part, while the LM index builds in its child process (one
host core; the timed full-depth run is a child process of its own):
  F1. ``train_fsdp_parity`` — ``train_dp_parity``'s shape, models and
     tolerances with ``placement="fsdp"`` over ``make_host_mesh(data=2)``
     and ``(data=4)`` (every slot's shards on the card), against the
     one-device step; no cut leaf, weight or moment, held whole by any
     slot between steps;
  F2. ``train_fsdp_full`` — ``train_full``'s run through
     ``launch.train.run(args, mesh=make_host_mesh(data=2))`` with
     ``--placement fsdp`` in a spawned process: step ms p50, tokens/s,
     ``mfu``, peak memory, one step with the layer gathers, the gradient
     reduce-scatters and the update timed by CUDA events, kernels a step
     (profiler); its first two losses within ``train_dp_full``'s
     tolerances of ``train_full``'s;
  F3. ``dryrun_fit`` — ``launch.dryrun`` on fake tensors for
     ``train_full``'s and ``train_fsdp_full``'s cells, the reckoned peak
     beside the measured ``torch.cuda.max_memory_allocated``.

The tensor-parallel phases (heads, FFN columns, experts and the
vocabulary cut over the model axis of a ``(data, model)`` mesh; no
kernel of the port runs in them either) run last, after the
data-parallel ones:
  P1. ``train_tp_parity`` — ``train_dp_parity``'s models and shape (2
     layers at published width, bf16, 8 × 128), 3 steps over
     ``make_host_mesh(data, model)`` at ``(1, 2)``, ``(2, 2)`` and
     ``(1, 4)``, every slot on the card, against the one-device steps:
     losses, aux losses and grad norms within ``FULL_LOSS_TOL`` (1e-3,
     2e-2, 5e-2 relative at steps 0, 1, 2); every slot's leaves of the
     spec tables' local shapes;
  P2. ``train_tp_full`` — ``train_full``'s run over ``(1, 2)`` on the
     card in a spawned process: step ms p50, tokens/s, ``mfu``, peak
     memory, one step with the TP collectives and the update timed by
     CUDA events, kernels a step (profiler); its first two losses within
     ``FULL_LOSS_TOL`` of ``train_full``'s.

The serving phases under tensor parallelism (the KV cache's sequence
cut over the model axis, heads, FFN, experts and vocabulary as in
training; no kernel of the port runs in them either) run last:
  S1. ``serve_tp_parity`` — ``train_tp_parity``'s models (2 layers at
     published width, bf16) and meshes, 8 prompts of 128 tokens and 16
     greedy decode steps through ``make_prefill`` / ``make_decode(...,
     mesh=)``, fed the one-device tokens: the last logits within
     ``LM_TOL``·max|logit| of the one-device calls' at every step, the
     tokens equal but at near ties; every slot's weights and cache
     pieces of the spec tables' local shapes;
  S2. ``serve_tp_full`` — qwen3-4b at full width and depth over ``(1,
     2)`` on the card, ``lm_generate``'s prompts and steps fed its
     tokens (equal but at near ties): prefill ms, decode ms a step, the
     serving collectives' ms and calls a step, kernels a decode step
     beside one device's, the peak and each slot's cache bytes.

``--phases build`` or ``--phases build,edges`` runs only those phases
and stops without the ``kernels`` and ``ok`` lines: a short check of new
kernels on the card; ``--phases beam`` runs the beam phase on a table
of its own and ``--phases graphs`` the graphs phase (both beside the
parent's kernel when ``build/parent`` holds a parent checkout);
``--phases`` also takes ``train_parity``,
``train_full``, ``train_embedder``, ``train_dp_parity``,
``train_dp_full`` (which runs ``train_full`` first), ``psum``,
``train_fsdp_parity``, ``train_fsdp_full`` (``train_full`` first),
``dryrun_fit`` (both full runs first), ``train_tp_parity`` and
``train_tp_full`` (``train_full`` first), ``serve_tp_parity`` and
``serve_tp_full`` (one device's generation in its own phase when
``lm_generate`` has not run).
"""

from __future__ import annotations

import contextlib
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


KERNEL_NAMES = ("topk_seg_f32_pass", "topk_dense_pass", "pairwise_f32_pass",
                "qtopk_seg_pass", "merge_flagged_partials",
                "tile_owner_ranges", "beam_f32_kernel")


def ptxas_summary(log: str):
    """One ``"name<template args>: R regs, S/L spill bytes"`` string per
    kernel from the ``-Xptxas -v`` log (template flags and ints in
    declaration order, e.g. ``topk_seg_f32_pass<L2,BF16,VEC,BQ,BN,TM,TN>``),
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
    phase_edges_d2560(dev, rng)
    phase_edges_unsegmented(dev, rng)


def phase_edges_d2560(dev, rng) -> None:
    """Kernels A and B at the LM's embedding width, d = 2,560 (qwen3-4b),
    under three owner layouts, before the ``lm`` phase relies on them."""
    from repro_torch.kernels import distance_topk
    for layout in ("runs", "random", "tombstones"):
        x = rng.standard_normal((128, 2560)).astype(np.float32)
        y = rng.standard_normal((6000, 2560)).astype(np.float32)
        qseg, cseg = owner_layout(rng, layout, 128, 6000)
        t = [torch.from_numpy(a).to(dev) for a in (x, y, qseg, cseg)]
        for accum, metric in (("f32", "l2"), ("bf16", "ip")):
            distance_topk.reset_tile_stats()
            err, tol = check_kernel_a(*t, 16, metric=metric, accum=accum)
            tiles = check_skip_count(t[2], t[3])
            emit(phase="edges", kernel="topk_seg_f32",
                 case=f"d2560_{layout}_{accum}", max_abs_err=err, tol=tol,
                 tiles=tiles)
        sq = _sq8_inputs(x, y, qseg, cseg, dev)
        for kp in (10, 40):
            distance_topk.reset_tile_stats()
            check_kernel_b(*sq, kp)
            tiles = check_skip_count(sq[6], sq[7], "qtopk_seg_sq8")
            emit(phase="edges", kernel="qtopk_seg_sq8",
                 case=f"d2560_{layout}_k{kp}", max_abs_err=0.0,
                 bit_equal=True, tiles=tiles)


def phase_edges_unsegmented(dev, rng) -> None:
    """The unsegmented kernels (``topk_f32``, ``qtopk_sq8``,
    ``pairwise_f32``) against their plain versions at edge shapes, up to
    the largest shape of ``benchmarks/bench_kernels.py``."""
    from repro_torch.kernels.distance_topk import dense_topk, distance_topk
    from repro_torch.kernels.quant import (quantize_sq8, quantized_topk,
                                           sq8_dense)
    from repro_torch.kernels.tuning import DENSE_WIDE, select_dense_tile

    def case(q, n, d, dup=False, offset=0):
        x, y, _, _ = _seg_case(rng, q, n, d, 1, dup)
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        if offset:  # a view `offset` words into its buffer: 4-byte copies
            buf = torch.empty(n * d + offset, device=dev)
            buf[offset:] = y.reshape(-1)
            y = buf[offset:].view(n, d)
        return x, y

    big = (1024, 65_536, 768)

    def k_max(resident):  # the wide tile's largest k at d = 128
        return max(k for k in range(1, 129)
                   if select_dense_tile(128, 128, k)
                   == (*DENSE_WIDE, resident))

    for name, shape, kp, metric, accum, dup, *offset in [
            ("k128", (100, 5000, 128), 128, "l2", "f32", False),
            ("k_wide_max", (128, 5000, 128), k_max(False), "l2", "f32",
             False),
            ("k_wide_resident_max", (128, 5000, 128), k_max(True), "l2",
             "f32", False),
            ("misaligned", (129, 3000, 128), 16, "l2", "f32", False, 1),
            ("ip_ties_splits", (128, 40_000, 64), 16, "ip", "f32", True),
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
        x, y = case(*shape, dup=dup, offset=offset[0] if offset else 0)
        err, tol = check_close_topk(distance_topk, dense_topk, x, y, kp,
                                    metric=metric, accum=accum)
        emit(phase="edges", kernel="topk_f32", case=name, kp=kp,
             max_abs_err=err, tol=tol)
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


def matching_rows(seqs, patterns, attributes=None):
    """Ids whose record satisfies each distinct predicate (host scan;
    ``attributes``: the records' attribute dicts, for tag and range
    predicates)."""
    from repro_torch.core.predicate import Contains, as_predicate
    out = {}
    for p in dict.fromkeys(patterns):
        pred = as_predicate(p)
        if isinstance(pred, Contains):
            hit = [i for i, s in enumerate(seqs) if p in s]
        elif attributes is None:
            hit = [i for i, s in enumerate(seqs) if pred.matches(s)]
        else:
            hit = [i for i, s in enumerate(seqs)
                   if pred.matches(s, attributes[i])]
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
    bq, bn = select_f32_tiles(q, segmented=True)
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
    """``topk_f32`` on the unfiltered phase's inputs (held against its
    plain version and timed beside it, the composition and its bound),
    its tile and split policy against the others it could take
    (``ms_by_policy``), its time at ``bench_max`` beside that bound, and
    what ``-Xptxas -v`` reported for its instantiations."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import distance_topk as dt
    from repro_torch.kernels import tuning
    from repro_torch.kernels.distance_topk import (dense_plan, dense_topk,
                                                   distance_topk)
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
    by_policy = {}          # the policy's choice against the others
    choose, waves = dt.select_dense_tile, tuning.DENSE_WAVES
    try:
        for name, tile, w in [("wide_waves1", None, 1),
                              ("wide_waves2", None, 2),
                              ("wide_waves3", None, 3),
                              ("narrow_waves1", tuning.DENSE_NARROW, 1)]:
            tuning.DENSE_WAVES = w
            if tile is not None:
                dt.select_dense_tile = (
                    lambda q_, d_, k_, t=tile: (*t, tuning.dense_smem_bytes(
                        *t, k_, d_, True) <= tuning.SMEM_BUDGET))
            by_policy[name] = cuda_ms(
                lambda: distance_topk(*args, **kwargs))
            dt.select_dense_tile = choose
    finally:
        tuning.DENSE_WAVES, dt.select_dense_tile = waves, choose
    gen = torch.Generator(device=x.device).manual_seed(7)
    bq_, bn_, dq_ = 1024, 65_536, 768           # bench_kernels.py's largest
    xb = torch.randn((bq_, dq_), generator=gen, device=x.device)
    yb = torch.randn((bn_, dq_), generator=gen, device=x.device)
    bench_ms = cuda_ms(lambda: distance_topk(xb, yb, 16), reps=3)
    bench_bound, bench_by = _bound((bq_ + bn_) * dq_ * 4 + bq_ * 16 * 8,
                                   2 * bq_ * bn_ * dq_, PEAK_F32)
    del xb, yb
    ptxas = [ln for ln in ptxas_summary(_build.build_log())[0]
             if ln.startswith("topk_dense_pass")]
    bq, bn, resident, splits = dense_plan(q, n, d, kp)
    return {"name": "topk_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_dense.cu",
            "replaces": "src/repro/kernels/distance_topk.py:62",
            "launches": launches, "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call ranks distances",
            "composition_ms": comp_ms,
            "tflops": 2 * q * n * d / ms / 1e9,
            "ms_by_policy": by_policy,
            "bench_max": {"Q": bq_, "N": bn_, "d": dq_, "kp": 16,
                          "ms": bench_ms, "bound_ms": bench_bound,
                          "bound_by": bench_by,
                          "tflops": 2 * bq_ * bn_ * dq_ / bench_ms / 1e9},
            "ptxas": ptxas,
            "shape": {"Q": q, "N": n, "d": d, "kp": kp, "bq": bq, "bn": bn,
                      "x_resident": resident, "splits": splits, **kwargs}}


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


def device_profile(fn, blocking=None, ranges=None, kernels=None):
    """``fn()`` once under ``torch.profiler``: (wall ms, device busy ms or
    None when the trace holds no device time, the top 8 device kernels
    by time).  With ``blocking`` (a dict), it also receives the host
    time and count of each ``BLOCKING`` call and of kernel launches, and
    under ``"device_kernels"`` the count of kernels the device ran.
    ``ranges`` (a dict keyed by ``record_function`` names): each entry
    receives that range's calls and the number of ``BLOCKING`` host
    calls made inside them.  ``kernels`` (a dict keyed by parts of
    kernel names): each entry receives the count and device ms of the
    device kernels whose names contain it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    if ranges is not None:
        host = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU]
        for name in ranges:
            spans = [e.time_range for e in host if e.name == name]
            ranges[name] = {"calls": len(spans), "blocking": sum(
                any(s.start <= e.time_range.start
                    and e.time_range.end <= s.end for s in spans)
                for e in host if e.name in BLOCKING)}
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
        for part in kernels or ():
            if part in e.key:
                got = kernels[part] or {"count": 0, "ms": 0.0}
                kernels[part] = {"count": got["count"] + e.count,
                                 "ms": got["ms"] + dev_us / 1e3}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) if rows else None   # None: no trace
    if blocking is not None:
        blocking["device_kernels"] = sum(r[2] for r in rows)
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
# phase 6: the sharded executor — 4 row shards of the main path's index
# --------------------------------------------------------------------- #

SHARDS = 4                  # logical row shards on the one card
SHARD_WAVES = 16            # waves per mode and per entry point


class KernelCounts:
    """Launches of kernels A and B on one path: ``span`` sets each
    wrapper's count to 0 just before it drives the path and adds the
    count to ``total`` just after, so the comparisons made between spans
    count nowhere."""

    def __init__(self):
        from repro_torch.kernels import distance_topk, quant
        self.wrappers = {"topk_seg_f32": distance_topk.topk_seg_f32,
                         "qtopk_seg_sq8": quant.qtopk_seg_sq8}
        self.total = dict.fromkeys(self.wrappers, 0)

    def span(self, fn):
        for w in self.wrappers.values():
            w.launches = 0
        out = fn()
        for k, w in self.wrappers.items():
            self.total[k] += w.launches
        return out


def _sharded_waves(run, single, qsets, counts, rt):
    """Each wave through ``run`` (counted, timed with a device sync) and
    through the one-device ``single`` (timed); the sharded answers must
    agree with the one-device answers under ``topk_agree``'s tolerance.
    Returns the answers, the times and the ``sq8_stats`` of the sharded
    waves alone (both paths count into the runtime's)."""
    ms = {"sharded": [], "single": []}
    sq8 = dict.fromkeys(rt.sq8_stats, 0)
    out = []
    for q in qsets:
        before = dict(rt.sq8_stats)
        t0 = time.perf_counter()
        res = counts.span(lambda: run(q))
        torch.cuda.synchronize()
        ms["sharded"].append((time.perf_counter() - t0) * 1e3)
        for k in sq8:
            sq8[k] += rt.sq8_stats[k] - before[k]
        t0 = time.perf_counter()
        want = single(q)
        torch.cuda.synchronize()
        ms["single"].append((time.perf_counter() - t0) * 1e3)
        check(recall_check(res, want) == 1.0,
              "sharded answers differ from the one-device path's")
        out.append(res)
    return out, ms, sq8


def sharded_kernel_shapes(primitive, q, rt):
    """Kernels A and B at a shard's shape: one sharded wave per scan with
    the wrappers captured, then each held against its plain version on
    the last shard's inputs and timed beside it (CUDA events), with its
    bound.  These launches count nowhere."""
    from repro_torch.kernels import distance_topk, quant
    from repro_torch.kernels.distance_topk import (segmented_dense_topk,
                                                   topk_seg_f32)
    from repro_torch.kernels.quant import qtopk_seg_sq8, sq8_dense_segmented
    out = {}
    rt.quantize, rt._sq8_bad_streak = "sq8", 0
    with Capture(quant, "qtopk_seg_sq8") as cap_b:
        primitive(q)
    rt.quantize = "none"
    with Capture(distance_topk, "topk_seg_f32") as cap_a:
        primitive(q)
    torch.cuda.synchronize()
    (x, y, qseg, cseg, kp), kw = cap_a.args
    err, tol = check_kernel_a(x, y, qseg, cseg, kp, **kw)
    pairs, live = _live_pairs(qseg, cseg)
    (qn, d), n = x.shape, y.shape[0]
    bound, by = _bound(qn * d * 4 + live * d * 4 + (qn + n) * 4
                       + qn * kp * 8, 2 * pairs * d, PEAK_F32)
    out["topk_seg_f32"] = {
        "ms": cuda_ms(lambda: topk_seg_f32(x, y, qseg, cseg, kp, **kw)),
        "plain_ms": cuda_ms(lambda: segmented_dense_topk(
            x, y, qseg, cseg, kp, **kw), reps=3),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "tol": tol,
        "shape": {"Qp": qn, "N": n, "d": d, "kp": kp,
                  "matched_pairs": pairs, "live_columns": live}}
    args = cap_b.args[0]
    xq, yq, kqp = args[0], args[1], args[8]
    err = check_kernel_b(*args)
    pairs, live = _live_pairs(args[6], args[7])
    (qn, d), n = xq.shape, yq.shape[0]
    bound, by = _bound(qn * (d + 8) + live * (d + 8) + (qn + n) * 4
                       + qn * kqp * 8, 2 * pairs * d, PEAK_INT8)
    out["qtopk_seg_sq8"] = {
        "ms": cuda_ms(lambda: qtopk_seg_sq8(*args)),
        "plain_ms": cuda_ms(lambda: sq8_dense_segmented(*args), reps=3),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err,
        "shape": {"Qp": qn, "N": n, "d": d, "kqp": kqp,
                  "matched_pairs": pairs, "live_columns": live}}
    del cap_a, cap_b
    torch.cuda.empty_cache()
    emit(phase="sharded_kernels", **out)
    return out


def phase_sharded(vm, vecs, rows_of, patterns):
    """The sharded executor on the main path's 1,048,576 × 128 index,
    split into ``SHARDS`` logical row shards on the card: (a) the
    residency build, then ``SHARD_WAVES`` waves per mode through
    ``sharded_plan_topk`` beside the one-device ``query_batch`` (equal
    answers, recall 1.0 against brute force on the card) and one
    profiled wave; (b) the same waves through ``RetrievalEngine(mesh=)``
    restored from a checkpoint; churn past the residency (inserts, resident
    deletes), a compaction, and the restore of the compacted engine onto
    the 2-shard mesh ``ElasticPlan.remesh`` picks over 3 devices, each
    held to brute force; (c) ``sharded_topk`` under a mask against
    ``ops.topk`` on the masked rows."""
    import tempfile

    from repro_torch.distributed import sharded_search
    from repro_torch.distributed.elastic import ElasticPlan
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import RetrievalEngine

    t_phase = time.perf_counter()
    rt = vm.runtime
    mesh = make_host_mesh(data=SHARDS, device="cuda")
    rt.quantize = "sq8"
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sh = rt.to_device_sharded(mesh)
    torch.cuda.synchronize()
    emit(phase="sharded_build", shards=SHARDS, local_n=sh.local_n,
         seconds=time.perf_counter() - t0,
         device_bytes=torch.cuda.memory_allocated() - mem0,
         csr_entries_per_shard=[int(x) for x in sh.csr_ptr[:, -1]])
    check(sh.local_n * SHARDS == len(vecs), "shards do not tile the table")

    rng = np.random.default_rng(11)
    qsets = [(vecs[rng.integers(0, len(vecs), 64)]
              + 0.3 * rng.standard_normal((64, vecs.shape[1]))).astype(
        np.float32) for _ in range(SHARD_WAVES)]
    dev_vecs = rt.to_device()["vectors"]
    oracle = [brute_force(dev_vecs, rows_of, q, patterns, K) for q in qsets]

    def primitive(q):
        snap = vm.snapshot()
        return sharded_search.sharded_plan_topk(
            mesh, None, snap, q, vm.plan(patterns, snap), K)

    def single(q):
        return vm.query_batch(q, patterns, K)

    counts = KernelCounts()
    lines, answers = {}, {}
    for mode in ("sq8", "none"):
        rt.quantize = mode
        rt._sq8_bad_streak = 0
        primitive(qsets[0])                        # warm: specs, tails
        single(qsets[0])
        traffic_0 = dict(rt.traffic)
        ops.reset_launch_stats()
        kc = KernelCounts()
        res, ms, sq8 = _sharded_waves(primitive, single, qsets, kc, rt)
        for w in range(SHARD_WAVES):
            rec = recall_check(res[w], oracle[w])
            check(rec == 1.0, f"sharded recall {rec} < 1.0 ({mode}, {w})")
        stats = ops.launch_stats()
        check(kc.total["topk_seg_f32"] + kc.total["qtopk_seg_sq8"]
              >= SHARDS * SHARD_WAVES,
              f"{mode}: fewer kernel launches than shards × waves: "
              f"{kc.total}")
        for k in counts.total:
            counts.total[k] += kc.total[k]
        answers[mode] = res
        lines[mode] = {
            "mode": mode, "waves": SHARD_WAVES, "recall": 1.0,
            "wave_ms_p25_p50_p75": {
                k: np.percentile(v, [25, 50, 75]).tolist()
                for k, v in ms.items()},
            "wave_ms": ms,
            "kernel_launches_per_wave": {
                k: v / SHARD_WAVES for k, v in kc.total.items()},
            "sweeps": {k: stats.get(k, 0) for k in
                       ("sharded_sweep", "sq8_sharded_sweep")},
            "sq8_stats": sq8,
            "shard_counters": {k: rt.traffic[k] - traffic_0[k]
                               for k in rt.traffic
                               if k.startswith("shard_")}}
        blocked = {}
        rt._sq8_bad_streak = 0
        wall_ms, busy, top = device_profile(lambda: primitive(qsets[1]),
                                            blocked)
        lines[mode]["profile"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall_ms,
            "top": top, "host_blocked": blocked}
        emit(phase="sharded_waves", **lines[mode])
    shapes = sharded_kernel_shapes(primitive, qsets[1], rt)

    with tempfile.TemporaryDirectory(prefix="sharded_") as tmp:
        # (b) the engine over the mesh, restored from a checkpoint
        ckpt = str(Path(tmp) / "index")
        vm.save(ckpt)
        rt.quantize = "sq8"
        t0 = time.perf_counter()
        eng = RetrievalEngine.restore(ckpt, mesh=mesh, device="cuda")
        eng.query_batch(qsets[0], patterns, K)
        torch.cuda.synchronize()
        first_wave_s = time.perf_counter() - t0
        engine_ms = {}
        for mode in ("sq8", "none"):
            eng.index.snapshot().quantize = mode
            eng.index.snapshot()._sq8_bad_streak = 0
            engine_ms[mode] = []
            for w, q in enumerate(qsets):
                t0 = time.perf_counter()
                got = counts.span(lambda: eng.query_batch(q, patterns, K))
                torch.cuda.synchronize()
                engine_ms[mode].append((time.perf_counter() - t0) * 1e3)
                check(recall_check(got, answers[mode][w]) == 1.0,
                      f"the mesh engine differs from sharded_plan_topk "
                      f"({mode}, wave {w})")
        eng.index.snapshot().quantize = "sq8"

        # churn past the residency, then a compaction
        ins_vecs, ins_seqs = new_scale_records(
            len(vecs), SERVE_INSERTS, vecs.shape[1])
        victims = rng.choice(len(vecs), SERVE_DELETES, replace=False)
        writes = ([("insert", v, s_) for v, s_ in zip(ins_vecs, ins_seqs)]
                  + [("delete", int(v)) for v in victims])
        churn_q = [qsets[2], qsets[3]]
        segments = [(writes, churn_q), ([("compact",)], churn_q)]
        want = stream_oracle(vecs, rows_of, patterns, segments, ins_vecs,
                             ins_seqs)
        t0 = time.perf_counter()
        for v, s_ in zip(ins_vecs, ins_seqs):
            eng.insert(v, s_)
        for v in victims:
            eng.delete(int(v))
        writes_s = time.perf_counter() - t0
        got = [counts.span(lambda: eng.query_batch(q, patterns, K))
               for q in churn_q]
        sh_e = eng.index.snapshot().to_device_sharded(mesh)
        check(int(sh_e.deleted[int(victims[0]) // sh_e.local_n][
            int(victims[0]) % sh_e.local_n]), "a delete never synced")
        t0 = time.perf_counter()
        eng.compact()
        compact_s = time.perf_counter() - t0
        got += [counts.span(lambda: eng.query_batch(q, patterns, K))
                for q in churn_q]
        for w, (g, o) in enumerate(zip(got, want)):
            rec = recall_check(g, o)
            check(rec == 1.0, f"recall {rec} < 1.0 through churn ({w})")

        # restore onto the mesh the elastic plan picks over 3 devices
        mesh2 = ElasticPlan(tp_degree=1, old_data=SHARDS).remesh(
            mesh.devices.flat[:3])
        check(mesh2.shape == {"data": 2, "model": 1},
              f"remesh over 3 devices gave {mesh2.shape}")
        ckpt2 = str(Path(tmp) / "compacted")
        eng.checkpoint(ckpt2)
        t0 = time.perf_counter()
        eng2 = RetrievalEngine.restore(ckpt2, mesh=mesh2, device="cuda")
        got2 = [counts.span(lambda: eng2.query_batch(q, patterns, K))
                for q in churn_q]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for w, (g, o) in enumerate(zip(got2, want[2:])):
            rec = recall_check(g, o)
            check(rec == 1.0, f"recall {rec} < 1.0 after the restore onto "
                  f"2 shards ({w})")
            check(recall_check(g, got[2 + w]) == 1.0,
                  "the 2-shard restore answers differently")
        emit(phase="sharded_engine", engine_first_wave_s=first_wave_s,
             wave_ms_p25_p50_p75={m: np.percentile(v, [25, 50, 75]).tolist()
                                  for m, v in engine_ms.items()},
             inserts=SERVE_INSERTS, deletes=SERVE_DELETES,
             writes_s=writes_s, compact_s=compact_s,
             restore_2_shards_s=restore_s, recall=1.0,
             sq8_stats=eng.index.snapshot().sq8_stats)
        del eng, eng2, sh_e
        torch.cuda.empty_cache()

    # (c) the raw primitive over the resident table, under a mask
    dev = dev_vecs.device
    mask = torch.zeros(len(vecs), dtype=torch.bool, device=dev)
    rows = torch.from_numpy(rows_of[patterns[5]]).to(dev)
    mask[rows] = True
    q = torch.from_numpy(qsets[4]).to(dev)
    d, i = counts.span(lambda: sharded_search.sharded_topk(
        mesh, q, dev_vecs, K, valid_mask=mask))
    dw, iw = ops.topk(q, dev_vecs[rows], K)
    iw = torch.where(iw >= 0, rows[iw.long().clamp_min(0)], -1)
    topk_agree(host(d), host(i), host(dw), host(iw),
               1e-4 * max(float(dw[torch.isfinite(dw)].abs().max()), 1.0))
    del sh
    torch.cuda.empty_cache()
    emit(phase="sharded_done", seconds=time.perf_counter() - t_phase,
         kernel_launches=counts.total)
    return counts.total, shapes


# --------------------------------------------------------------------- #
# phase 7: graph states, churn and compaction
# --------------------------------------------------------------------- #

def _graph_free_requests(vm, patterns):
    plan = vm.plan(patterns)
    free = set(range(len(patterns))) - set(plan.misses)
    for e in plan.entries:
        if any(s.graph_states for s in e.sources):
            free -= set(e.requests)
    return sorted(free)


def phase_graphs():
    import tempfile

    from repro_torch.core import hnsw_torch
    from repro_torch.core.predicate import as_predicate
    from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
    from repro_torch.data.corpora import make_corpus, sample_patterns

    vecs, seqs = make_corpus("code")
    cfg = dict(T=50, M=8, ef_con=60, auto_compact=False)
    t0 = time.perf_counter()
    # one host build; the card's and the CPU's torch executors take the
    # same index from its checkpoint (three builds took 220 s, PR 16)
    vms = {"numpy": VectorMaton(vecs, seqs, VectorMatonConfig(
        backend="numpy", **cfg))}
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="graphs_") as tmp:
        vms["numpy"].save(str(Path(tmp) / "index"))
        for dev in ("cuda", "cpu"):
            vms[dev] = VectorMaton.load(
                str(Path(tmp) / "index"),
                config=VectorMatonConfig(device=dev, **cfg), device=dev)
    restore_s = time.perf_counter() - t0 - build_s
    n_graphs = len(vms["cuda"].runtime.graphs)
    check(n_graphs > 0, "the code corpus built no graph states")
    rng = np.random.default_rng(2)
    patterns = (sample_patterns(seqs, 2, 32, seed=1)
                + sample_patterns(seqs, 1, 32, seed=2))
    live_seqs = list(seqs)
    hnsw_torch.beam_f32.launches = 0
    card_beams = 0              # the card executor's beam calls

    def wave(name):
        nonlocal card_beams
        q = rng.standard_normal((len(patterns), vecs.shape[1])).astype(
            np.float32)
        t0 = time.perf_counter()
        res = {}
        for b, vm in vms.items():
            before = graph_beam_calls()
            res[b] = vm.query_batch(q, patterns, K)
            if b == "cuda":
                card_beams += graph_beam_calls() - before
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
    launches = hnsw_torch.beam_f32.launches
    check(launches == card_beams > 0,
          f"beam_f32 launched {launches} times for the card executor's "
          f"{card_beams} beam calls")
    emit(phase="graphs_done", graph_states=n_graphs, build_s=build_s,
         save_and_restore_s=restore_s,
         compactions=stats["cuda"]["compactions"],
         launch_graph_fused=stats["cuda"].get("launch_graph_fused", 0),
         launch_graph_fused_filt=stats["cuda"].get(
             "launch_graph_fused_filt", 0),
         card_beam_calls=card_beams, beam_f32_launches=launches)
    # after the counted waves, one wave on the card under the profiler:
    # one beam_f32 launch a bucket, no host sync inside the beam's range
    blocked, beam_kernel = {}, {"beam_f32_kernel": None}
    q = rng.standard_normal((len(patterns), vecs.shape[1])).astype(
        np.float32)
    beams, calls = _beam_ranges()
    try:
        wall_ms, busy, top = device_profile(
            lambda: vms["cuda"].query_batch(q, patterns, K), blocked, beams,
            beam_kernel)
    finally:
        _beam_ranges(restore=True)
    n_calls = sum(len(c) for c in calls.values())
    got = beam_kernel["beam_f32_kernel"] or {"count": 0, "ms": 0.0}
    check(got["count"] == n_calls > 0,
          f"{got['count']} beam_f32 kernels for {n_calls} beam calls in the "
          "profiled wave")
    check(all(r["blocking"] == 0 for r in beams.values()),
          f"host syncs inside the beam's range: {beams}")
    # the wave's beam calls again: this kernel beside the parent's
    replay = _beam_replay([c for name in _BEAMS for c in calls[name]],
                          parent_hnsw())
    emit(phase="graphs_profile", wall_ms=wall_ms, device_busy_ms=busy,
         top=top[:4], host_blocked=blocked, beam_kernel=got,
         beam={name: {**beams[name], **_beam_bound(calls[name])}
               for name in calls}, beam_replay=replay,
         beam_integer_checks=beam_int_check(
             [c for name in _BEAMS for c in calls[name]], seed=12))
    return launches, {"profiled_ms": got["ms"], **replay}


GRAPH_BEAMS = ("graph_fused", "graph_fused_filt", "graph_state",
               "graph_state_filt")


def graph_beam_calls() -> int:
    """The executors' beam calls so far (``ops.launch_stats``: fused
    buckets, filtered buckets and the per-state launches)."""
    from repro_torch.kernels import ops
    stats = ops.launch_stats()
    return sum(stats.get(kind, 0) for kind in GRAPH_BEAMS)


_BEAMS = ("hnsw_search_fused", "hnsw_search_fused_filtered")


def _beam_ranges(restore: bool = False):
    """The executor's two beam entry points, each wrapped in a
    ``record_function`` range of its name that keeps its calls'
    arguments: ({name: {}} for ``device_profile``'s ``ranges``, {name:
    [(args, kwargs)]}).  ``restore`` puts the originals back."""
    from repro_torch.core import hnsw_torch, packed
    if restore:
        for name in _BEAMS:
            setattr(packed, name, getattr(hnsw_torch, name))
        return None
    calls = {name: [] for name in _BEAMS}

    def wrap(name):
        fn = getattr(hnsw_torch, name)

        def ranged(*args, **kwargs):
            calls[name].append((args, kwargs))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return ranged
    for name in _BEAMS:
        setattr(packed, name, wrap(name))
    return {name: {} for name in _BEAMS}, calls


def _beam_call(args, kw):
    """An entry point's recorded call as ``beam_f32``'s arguments:
    (positional with ``level0``, keywords without ``nbr``, ``nbr``, built
    from ``level0`` when the call passed none)."""
    if len(args) == 8:                              # the filtered variant
        vectors, ids, level0, entry, masks, midx, gidx, queries = args
        fk = dict(masks=masks, midx=midx)
    else:
        vectors, ids, level0, entry, gidx, queries = args
        fk = {}
    fk.update({k: kw[k] for k in ("k", "ef", "metric")},
              max_iter=kw.get("max_iter"))
    nbr = kw.get("nbr")
    if nbr is None:
        from repro_torch.core import hnsw_torch
        nbr = hnsw_torch.neighbour_table(ids, level0)
    return (vectors, ids, level0, entry, gidx, queries), fk, nbr


def _on_table(args, nbr):
    """``beam_f32``'s positional arguments: ``args`` (as ``_beam_call``
    gives them) with ``nbr`` in place of ``level0``."""
    return args[:2] + (nbr,) + args[3:]


def _beam_bound(calls):
    """The least time the beam calls could take: ``beam_bytes`` of each
    call, with the pairs' visited and expanded slots from the kernel's
    optional outputs (the calls launched again with ``stats``), over the
    card's memory rate."""
    from repro_torch.core import hnsw_torch
    nbytes, visited, unique, steps_max = 0, 0, 0, 0
    for args, kw in calls:
        args, fk, nbr = _beam_call(args, kw)
        _, ids, level0, _, gidx, queries = args
        _, _, st = hnsw_torch.beam_f32(*_on_table(args, nbr), stats=True,
                                       **fk)
        b = beam_bytes(ids, level0, gidx, queries, kw["k"], st,
                       fk.get("midx"))
        nbytes += b["bytes"]
        visited += b["visited"]
        unique += b["visited_unique"]
        steps_max = max(steps_max, int(st["steps"].max()))
    return {"visited_nodes": visited, "visited_unique": unique,
            "steps_max": steps_max, "bound_bytes": nbytes,
            "bound_ms": nbytes / PEAK_BYTES * 1e3}


def _beam_replay(calls, parent) -> dict:
    """The recorded beam calls of a wave launched again, in their order,
    by this checkout's ``beam_f32`` and, with ``parent``, the parent
    checkout's (its kernel reads a contiguous level0 and ids, not the
    neighbour table), in turns (parent, change, change, parent): ``ms``,
    all of them from CUDA events (the host's launch gaps included),
    ``kernel_ms``, their kernels' device time (``torch.profiler``), and
    each wrapper's host work a call (``host_work``, also in turns)."""
    from repro_torch.core import hnsw_torch
    runs = []
    for args, kw in calls:
        args, fk, nbr = _beam_call(args, kw)
        runs.append((_on_table(args, nbr),
                     args[:2] + (args[2].contiguous(),) + args[3:], fk))

    def change():
        for args, _, fk in runs:
            hnsw_torch.beam_f32(*args, **fk)

    def old():
        for _, args, fk in runs:
            parent.beam_f32(*args, **fk)

    def kernel_ms(fn, reps=5):
        # a kernel's mean device time times the calls: a trace of this
        # length can lose some of its events
        fn()
        found = {"beam_f32_kernel": None}
        device_profile(lambda: [fn() for _ in range(reps)], None, None,
                       found)
        got = found["beam_f32_kernel"]
        return got["ms"] / got["count"] * len(runs)
    if parent is None:
        return {"calls": len(runs), "ms": cuda_ms(change, reps=10),
                "kernel_ms": kernel_ms(change),
                "host_work": {"change": beam_host_work(change, len(runs))}}
    host = {"parent": [], "change": []}
    for name, fn in (("parent", old), ("change", change),
                     ("change", change), ("parent", old)):
        host[name].append(beam_host_work(fn, len(runs)))
    host = {name: {k: (a[k] + b[k]) / 2 for k in a}
            for name, (a, b) in host.items()}
    ms, parent_ms = ab_ms(change, old, reps=10)
    first = kernel_ms(old)
    kms = (kernel_ms(change) + kernel_ms(change)) / 2
    return {"calls": len(runs), "ms": ms, "parent_ms": parent_ms,
            "kernel_ms": kms,
            "parent_kernel_ms": (first + kernel_ms(old)) / 2,
            "host_work": host}


def beam_host_work(fn, calls: int, reps: int = 50) -> dict:
    """The host's work a beam call when ``fn`` makes ``calls`` of them:
    ``host_us``, the mean time ``fn`` takes to return (the card
    synchronized between repetitions, so no launch waits for room in its
    queue), and the aten ops (a ``TorchDispatchMode``) and Python calls
    (``sys.setprofile``) it makes, each a call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            Ops.n += 1
            return func(*a, **(kw or {}))
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    py = [0]

    def count(frame, event, arg):
        if event in ("call", "c_call"):
            py[0] += 1
    sys.setprofile(count)
    fn()
    sys.setprofile(None)
    with Ops():
        fn()
    torch.cuda.synchronize()
    return {"host_us": total / reps / calls * 1e6,
            "aten_ops": Ops.n / calls, "python_calls": py[0] / calls}


def beam_int_check(calls, seed: int, most: int = 6) -> dict:
    """Recorded beam calls (``_beam_ranges``'s), the first of each of up
    to ``most`` shapes, again on integer-valued vectors and queries in
    [-3, 3] of the calls' own shapes (every distance exact in fp32):
    ``beam_f32`` bit-equal to ``_beam`` with the query in shared memory,
    with the query (and ef-list) in device memory by budgets of 0 bytes,
    and at d - 1 (float4 loads where d or d - 1 is a multiple of 4,
    scalar ones at the other).  Returns the checks made and the shapes."""
    from repro_torch.core import hnsw_torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes, ints, made, found = [], {}, 0, 0
    for args, kw in calls:
        args, fk, nbr = _beam_call(args, kw)
        vectors, ids, level0, entry, gidx, queries = args
        key = (tuple(nbr.shape), tuple(queries.shape), fk["k"], fk["ef"],
               fk["metric"], "masks" in fk)
        if key in shapes:
            continue
        if len(shapes) == most:
            break
        shapes.append(key)
        if vectors.shape not in ints:
            ints[vectors.shape] = torch.randint(
                -3, 4, vectors.shape, generator=gen, device="cuda").float()
        iv = ints[vectors.shape]
        iq = torch.randint(-3, 4, queries.shape, generator=gen,
                           device="cuda").float()
        d = iv.shape[1]
        runs = ((iv, iq, "shared"), (iv, iq, "global"),
                (iv[:, :d - 1].contiguous(), iq[:, :d - 1].contiguous(),
                 "shared"))
        for v, q, place in runs:
            loads = "float4" if v.shape[1] % 4 == 0 else "scalar"
            pd, pi = hnsw_torch._beam(v, ids, level0, entry, gidx, q, **fk)
            saved = hnsw_torch._SMEM_LIST, hnsw_torch._SMEM_QUERY
            if place == "global":
                hnsw_torch._SMEM_LIST = hnsw_torch._SMEM_QUERY = 0
            try:
                kd, ki, st = hnsw_torch.beam_f32(v, ids, nbr, entry, gidx, q,
                                                 stats=True, **fk)
            finally:
                hnsw_torch._SMEM_LIST, hnsw_torch._SMEM_QUERY = saved
            tag = f"beam at {key}, d {v.shape[1]}, {loads} loads, " \
                f"query {place}"
            check(st["query"] == place, f"{tag}: query {st['query']}")
            check(torch.equal(ki, pi) and torch.equal(
                kd.view(torch.int32), pd.view(torch.int32)),
                f"{tag}: the kernel differs from _beam")
            found += int((ki >= 0).sum())
            made += 1
    check(made > 0, "no beam call to check on integer data")
    return {"checks": made, "d": d, "ids_found": found,
            "shapes": [list(map(str, k)) for k in shapes]}


def ab_ms(change, parent, reps: int = 5):
    """Mean ms of ``change`` and of ``parent`` (CUDA events), timed in
    turns: parent, change, change, parent."""
    first = cuda_ms(parent, reps)
    a, b = cuda_ms(change, reps), cuda_ms(change, reps)
    return (a + b) / 2, (first + cuda_ms(parent, reps)) / 2


BEAM_PARENT = ROOT / "build" / "parent"


def parent_hnsw():
    """The parent checkout's ``core.hnsw_torch`` when one is unpacked at
    ``build/parent`` (``git archive <parent> | tar -x -C build/parent``),
    imported as package ``repro_torch_parent`` with its kernels built from
    its own sources into its own tree; None without one.  The beam and
    graphs phases time its ``beam_f32`` beside this checkout's."""
    import importlib
    import importlib.util
    src = BEAM_PARENT / "src" / "repro_torch"
    if not (src / "core" / "hnsw_torch.py").exists():
        return None
    name = "repro_torch_parent"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, src / "__init__.py", submodule_search_locations=[str(src)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        build = importlib.import_module(name + ".kernels._build")
        t0 = time.perf_counter()
        build.library()
        ptxas, spills = ptxas_summary(build.build_log())
        emit(phase="beam_parent", root=str(BEAM_PARENT),
             build_s=time.perf_counter() - t0,
             ptxas=[ln for ln in ptxas if ln.startswith("beam")],
             spilling_kernels=[n for n in spills if n.startswith("beam")])
    return importlib.import_module(name + ".core.hnsw_torch")


def beam_bytes(ids, level0, gidx, queries, k, stats, midx=None) -> dict:
    """The bytes one beam call must move, each input read once however
    many pairs need it: the vector of every global id that some pair
    visited, the ``ids`` entry of every visited (graph, slot), the mask
    byte of every visited (mask row, global id), the level-0 row of every
    expanded (graph, slot), each searched graph's entry, the queries, the
    pairs' graph (and mask) indices and the results.  ``stats``:
    ``beam_f32(stats=True)``'s; also returns the visited slots summed
    over pairs and over unique (graph, slot)."""
    p, d = queries.shape
    n, m2 = ids.shape[1], level0.shape[2]
    g = gidx.long()
    pair, slot = stats["visited"].nonzero(as_tuple=True)
    gid = ids[g[pair], slot].long()
    nodes = int(torch.unique(g[pair] * n + slot).numel())
    ex_pair, ex_step = (stats["expanded"] >= 0).nonzero(as_tuple=True)
    rows = int(torch.unique(
        g[ex_pair] * n + stats["expanded"][ex_pair, ex_step]).numel())
    nbytes = (int(torch.unique(gid).numel()) * 4 * d + nodes * 4
              + rows * m2 * 4 + int(torch.unique(g).numel()) * 4
              + p * (4 * d + 4) + p * k * 8)
    if midx is not None:
        v_n = int(ids.max()) + 1
        nbytes += int(torch.unique(midx.long()[pair] * v_n + gid).numel()) \
            + 4 * p
    return {"bytes": nbytes, "visited": int(pair.numel()),
            "visited_unique": nodes}


# --------------------------------------------------------------------- #
# the beam kernel at the main path's table size
# --------------------------------------------------------------------- #

BEAM_GRAPHS, BEAM_NODES = 8, 131_072    # one bucket covering the table
BEAM_QUERIES, BEAM_M2, BEAM_EF = 64, 32, 64     # the paper's M = 16, ef 64
BEAM_MASKS, BEAM_DENSITY = 4, (0.1, 0.5)
BEAM_BITMAP = {"bucket": "shared", "graph_1m": "global"}


def beam_graphs(table: torch.Tensor, seed: int):
    """{"bucket": (ids, level0, entry) of BEAM_GRAPHS graphs, each over
    BEAM_NODES consecutive rows of ``table``, every node joined to its
    BEAM_M2 exact nearest neighbours within its graph (``ops.topk``,
    i.e. ``topk_f32``), "graph_1m": the one graph over the whole table:
    the same lists at global slots, each node's last edge sent to a
    seeded random node of another of the eight}."""
    from repro_torch.kernels import ops
    dev, n = table.device, BEAM_NODES
    rows = torch.arange(n, device=dev)
    lists = []
    for g in range(BEAM_GRAPHS):
        part = table[g * n:(g + 1) * n]
        _, nn = ops.topk(part, part, BEAM_M2 + 1)
        nn = nn.long()
        keep = nn != rows[:, None]
        keep[:, -1] &= ~keep.all(1)         # no self in the list: drop last
        lists.append(nn[keep].view(n, BEAM_M2))
    level0 = torch.stack(lists)
    rng = np.random.default_rng(seed)
    g_of = np.repeat(np.arange(BEAM_GRAPHS), n)
    other = (g_of + rng.integers(1, BEAM_GRAPHS, g_of.size)) % BEAM_GRAPHS
    big = (level0 + n * torch.arange(BEAM_GRAPHS, device=dev)[:, None, None]
           ).view(BEAM_GRAPHS * n, BEAM_M2)
    big[:, -1] = torch.from_numpy(other * n + rng.integers(0, n, g_of.size)
                                  ).to(dev)
    ids = torch.arange(BEAM_GRAPHS * n, dtype=torch.int32, device=dev)
    entry = torch.from_numpy(rng.integers(0, n, BEAM_GRAPHS).astype(
        np.int32)).to(dev)
    return {"bucket": (ids.view(BEAM_GRAPHS, n),
                       level0.to(torch.int32).contiguous(), entry),
            "graph_1m": (ids[None], big.to(torch.int32)[None].contiguous(),
                         entry[:1].clone())}


BEAM_WIDE = {"ef_1040": (33, 1040), "m2_130": (130, 64)}   # (2M, ef)
BEAM_WIDE_NODES = 4096


def beam_wide_graph(m2: int, seed: int):
    """(ids, level0, entry) of one graph of BEAM_WIDE_NODES nodes over the
    table's first rows, each row m2 seeded random neighbours; past 128
    positions (two chunks of the kernel's row) every eleventh row a real
    0 at position 127 then pads, the next that row's neighbour at
    position 3 again at 129."""
    n = BEAM_WIDE_NODES
    rng = np.random.default_rng(seed)
    lvl = rng.integers(1, n, (n, m2)).astype(np.int32)
    if m2 > 129:
        lvl[::11, 127] = 0
        lvl[::11, 128:] = -1
        lvl[1::11, 129] = lvl[1::11, 3]
    ids = np.arange(n, dtype=np.int32)[None]
    entry = np.array([n // 3], np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (ids, lvl[None], entry))


def beam_split(stats) -> dict:
    """The longest pair's steps and its clock64() cycles a step by phase
    (``hnsw_torch._PROF``), from ``beam_f32(stats=True)``."""
    from repro_torch.core import hnsw_torch
    steps = stats["steps"]
    i = int(steps.argmax())
    n = max(int(steps[i]), 1)
    cyc = stats["cycles"][i].tolist()
    return {"steps": int(steps[i]),
            "cycles_per_step": {name: c / n for name, c in
                                zip(hnsw_torch._PROF, cyc)}}


def phase_beam(table: torch.Tensor = None) -> dict:
    """``beam_f32`` against ``hnsw_torch._beam`` on the main path's table
    (``make_scale_corpus(1_048_576, 128)``; made here when no table is
    given): one bucket of BEAM_GRAPHS graphs of BEAM_NODES nodes, each of
    the 64 queries against each graph (P = 512, shared-memory bitmaps),
    and the one graph of 1,048,576 nodes (P = 64, global bitmaps); M = 16
    (2M = 32), ef = 64, k = 10; l2 and ip; unfiltered and under 4 masks
    at 10 % and 50 % of ids allowed; on integer-valued vectors and
    queries in [-8, 8] (every distance exact in fp32: bit-equal to
    ``_beam`` on every pair, the kernel's visited slots, which the bound
    reads, equal to ``_beam``'s, the bitmaps where ``BEAM_BITMAP`` says)
    and on the table's float vectors (≥ 99 % of pairs the same ids,
    recall@10 against ``_beam`` ≥ 0.995); every
    returned distance within 1e-5 of its fp32 recomputation relative to
    the sum of its terms' magnitudes, every returned id allowed by its
    mask.  The float cases are timed (CUDA events) beside ``_beam``, the
    bound and, with a parent checkout, the parent's
    kernel; then the BEAM_WIDE shapes on integer data, bit-equal to
    ``_beam`` with the ef-list in shared and in device memory, timed.
    Returns the ``kernels`` line's record."""
    from repro_torch.core import hnsw_torch
    from repro_torch.kernels import _build
    if table is None:
        from repro_torch.data.corpora import make_scale_corpus
        table = torch.from_numpy(make_scale_corpus(1_048_576, 128)[0]).cuda()
    parent = parent_hnsw()
    dev = table.device
    v_n, d = table.shape
    t0 = time.perf_counter()
    graphs = beam_graphs(table, seed=5)
    nbrs = {size: hnsw_torch.neighbour_table(ids, level0)
            for size, (ids, level0, _) in graphs.items()}
    torch.cuda.synchronize()
    graphs_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(rng.integers(0, v_n, BEAM_QUERIES)).to(dev)
    noise = torch.from_numpy(0.3 * rng.standard_normal(
        (BEAM_QUERIES, d)).astype(np.float32)).to(dev)
    data = {"int": (torch.randint(-8, 9, (v_n, d), generator=gen,
                                  device=dev).float(),
                    torch.randint(-8, 9, (BEAM_QUERIES, d), generator=gen,
                                  device=dev).float()),
            "float": (table, (table[rows] + noise).contiguous())}
    masks = {f: torch.rand((BEAM_MASKS, v_n), generator=gen, device=dev) < f
             for f in BEAM_DENSITY}
    cases, max_err = {}, 0.0
    for size, (ids, level0, entry) in graphs.items():
        g_n, n = ids.shape
        gidx = torch.arange(g_n, dtype=torch.int32,
                            device=dev).repeat_interleave(BEAM_QUERIES)
        p = int(gidx.shape[0])
        midx = torch.arange(p, dtype=torch.int32, device=dev) % BEAM_MASKS
        for kind, (vecs, q) in data.items():
            queries = q.repeat(g_n, 1).contiguous()
            for metric in ("l2", "ip"):
                for frac in (None,) + BEAM_DENSITY:
                    tag = f"{size}/{kind}/{metric}/{frac or 'unfiltered'}"
                    fk = ({} if frac is None
                          else dict(masks=masks[frac], midx=midx))
                    args = (vecs, ids, level0, entry, gidx, queries)
                    targs = _on_table(args, nbrs[size])
                    kw = dict(k=K, ef=BEAM_EF, metric=metric, **fk)
                    kd, ki, st = hnsw_torch.beam_f32(*targs, stats=True,
                                                     **kw)
                    check((st["bitmap"], st["list"])
                          == (BEAM_BITMAP[size], "shared"),
                          f"beam {tag}: {st['bitmap']} bitmaps and "
                          f"{st['list']} lists, not {BEAM_BITMAP[size]} "
                          "and shared")
                    plain_visited = []
                    pd, pi = hnsw_torch._beam(*args, max_iter=None, **kw,
                                              visited_out=plain_visited)
                    found, steps = ki >= 0, st["steps"]
                    line = {"bitmap": st["bitmap"], "pairs": p, "nodes": n,
                            "steps_max": int(steps.max()),
                            "steps_mean": float(steps.float().mean()),
                            "visited_mean": float(
                                st["visited"].sum(1).float().mean()),
                            "found_mean": float(found.float().sum(1).mean()),
                            "split": beam_split(st)}
                    if kind == "int":
                        check(torch.equal(ki, pi) and torch.equal(
                            kd.view(torch.int32), pd.view(torch.int32)),
                            f"beam {tag}: the kernel differs from _beam")
                        check(torch.equal(st["visited"], plain_visited[0]),
                              f"beam {tag}: visited slots differ")
                    else:
                        same = float((ki == pi).all(1).float().mean())
                        hit = ((pi[:, :, None] == ki[:, None, :]).any(2)
                               & (pi >= 0))
                        rec = float(hit.sum()) / max(int((pi >= 0).sum()), 1)
                        check(same >= 0.99 and rec >= 0.995,
                              f"beam {tag}: {same} of pairs the same ids, "
                              f"recall {rec} against _beam")
                        both = (ki == pi) & found
                        if bool(both.any()):
                            max_err = max(max_err, float(
                                (kd - pd)[both].abs().max()))
                        line.update(same_ids_share=same, recall=rec)
                    v = vecs[ki.clamp_min(0).long()]
                    terms = (v - queries[:, None, :]) ** 2 if metric == "l2" \
                        else -v * queries[:, None, :]
                    true, scale = terms.sum(-1), terms.abs().sum(-1)
                    off = (kd - true).abs()
                    check(bool((off <= 1e-5 * scale)[found].all()),
                          f"beam {tag}: a distance off its recomputation")
                    line["max_rel_err"] = float(
                        (off / scale.clamp_min(1e-30))[found].max()) \
                        if bool(found.any()) else 0.0
                    if frac is not None:
                        ok = masks[frac][midx.long()[:, None],
                                         ki.clamp_min(0).long()]
                        check(bool((ok | ~found).all()),
                              f"beam {tag}: an id its mask does not allow")
                    if kind == "float":
                        def change():
                            hnsw_torch.beam_f32(*targs, **kw)
                        if parent is None:
                            line["ms"] = cuda_ms(change, reps=20)
                        else:
                            line["ms"], line["parent_ms"] = ab_ms(
                                change, lambda: parent.beam_f32(*args, **kw),
                                reps=20)
                            _, _, pst = parent.beam_f32(*args, stats=True,
                                                        **kw)
                            line["parent_steps_max"] = int(pst["steps"].max())
                            line["parent_us_per_step"] = (
                                line["parent_ms"] * 1e3
                                / max(line["parent_steps_max"], 1))
                        line["plain_ms"] = cuda_ms(
                            lambda: hnsw_torch._beam(*args, max_iter=None,
                                                     **kw), reps=1, warmup=0)
                        b = beam_bytes(ids, level0, gidx, queries, K, st,
                                       None if frac is None else midx)
                        line.update(bound_bytes=b["bytes"],
                                    bound_ms=b["bytes"] / PEAK_BYTES * 1e3,
                                    visited_unique=b["visited_unique"],
                                    us_per_step=line["ms"] * 1e3
                                    / max(line["steps_max"], 1))
                    cases[tag] = line
                    emit(phase="beam", case=tag, **line)
    nbr_bytes = {size: t.numel() * t.element_size()
                 for size, t in nbrs.items()}
    del graphs, nbrs, masks
    torch.cuda.empty_cache()
    wide = phase_beam_wide(data["int"])
    main = cases["bucket/float/l2/unfiltered"]
    ptxas, spills = ptxas_summary(_build.build_log())
    record = {"name": "beam_f32", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/beam.cu",
              "replaces": "src/repro/core/hnsw_jax.py:233",
              "launches": 0, "max_abs_err": max_err, "ms": main["ms"],
              "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
              "bound_by": "bytes", "library_ms": None,
              "shape": {"pairs": main["pairs"], "nodes": BEAM_NODES,
                        "graphs": BEAM_GRAPHS, "d": d, "m2": BEAM_M2,
                        "ef": BEAM_EF, "k": K},
              "steps_max": main["steps_max"],
              "us_per_step": main["us_per_step"], "split": main["split"],
              "nbr_bytes": nbr_bytes,
              "ptxas": [ln for ln in ptxas if ln.startswith("beam")],
              "spilling": [n for n in spills if n.startswith("beam")],
              "cases": {t: {k: c[k] for k in (
                  "ms", "parent_ms", "plain_ms", "bound_ms", "steps_max",
                  "us_per_step", "parent_us_per_step", "bitmap")
                  if k in c} for t, c in cases.items() if "ms" in c},
              "wide": wide}
    if "parent_ms" in main:
        record["parent_ms"] = main["parent_ms"]
    emit(phase="beam_done", graphs_s=graphs_s, cases=len(cases),
         max_abs_err=max_err, nbr_bytes=nbr_bytes)
    del data
    torch.cuda.empty_cache()
    return record


def phase_beam_wide(data) -> dict:
    """The BEAM_WIDE shapes (past the earlier kernel's limits of ef 1,024
    and 2M 128) through the entry points on integer data (``data``:
    vectors and 64 queries): each bit-equal to ``_beam`` with the
    kernel's ef-list in shared memory and, by a budget of 0 bytes, in
    device memory, l2 unfiltered and filtered (half the ids allowed),
    ``beam_f32`` launched each time; each launch timed."""
    from repro_torch.core import hnsw_torch
    vecs, q = data
    p = int(q.shape[0])
    gidx = torch.zeros(p, dtype=torch.int32, device=q.device)
    masks = torch.rand((2, vecs.shape[0]), device=q.device,
                       generator=torch.Generator(device=q.device)
                       .manual_seed(9)) < 0.5
    midx = torch.arange(p, dtype=torch.int32, device=q.device) % 2
    out = {}
    for name, (m2, ef) in BEAM_WIDE.items():
        ids, level0, entry = beam_wide_graph(m2, seed=m2)
        args = (vecs, ids, level0, entry, gidx, q)
        targs = _on_table(args, hnsw_torch.neighbour_table(ids, level0))
        for filt in (False, True):
            fk = dict(masks=masks, midx=midx) if filt else {}
            kw = dict(k=K, ef=ef, metric="l2", **fk)
            pd, pi = hnsw_torch._beam(*args, max_iter=None, **kw)
            for budget, place in ((hnsw_torch._SMEM_MAX, "shared"),
                                  (0, "global")):
                saved = hnsw_torch._SMEM_LIST
                hnsw_torch._SMEM_LIST = budget
                try:
                    before = hnsw_torch.beam_f32.launches
                    entry_point = (hnsw_torch.hnsw_search_fused_filtered
                                   if filt else hnsw_torch.hnsw_search_fused)
                    call_args = ((vecs, ids, level0, entry, masks, midx,
                                  gidx, q) if filt else args)
                    kd, ki = entry_point(*call_args, k=K, ef=ef,
                                         metric="l2")
                    torch.cuda.synchronize()
                    check(hnsw_torch.beam_f32.launches == before + 1,
                          f"beam {name}: beam_f32 was not launched")
                    _, _, st = hnsw_torch.beam_f32(*targs, stats=True,
                                                   **kw)
                    ms = cuda_ms(lambda: hnsw_torch.beam_f32(*targs, **kw),
                                 reps=3)
                finally:
                    hnsw_torch._SMEM_LIST = saved
                tag = f"{name}/{'filtered' if filt else 'unfiltered'}/{place}"
                check(torch.equal(ki, pi) and torch.equal(
                    kd.view(torch.int32), pd.view(torch.int32)),
                    f"beam {tag}: the kernel differs from _beam")
                check(st["list"] == place,
                      f"beam {tag}: {st['list']} list, not {place}")
                out[tag] = {"m2": m2, "ef": ef, "pairs": p,
                            "nodes": BEAM_WIDE_NODES, "ms": ms,
                            "steps_max": int(st["steps"].max()),
                            "bitmap": st["bitmap"], "list": st["list"]}
                emit(phase="beam_wide", case=tag, **out[tag])
    return out


# --------------------------------------------------------------------- #
# phase 8: the LM serving path — qwen3-4b embeds, VectorMaton serves
# --------------------------------------------------------------------- #

LM_ARCH = "qwen3-4b"
LM_WIDTH = 96           # byte tokens a record (pattern_search.py's, uncut)
LM_BATCH = 64           # records an embedding batch
LM_INDEX = dict(T=40, M=8, ef_con=50)       # pattern_search.py's index
LM_SCHEMA = {"genre": "tag", "price": "numeric"}
LM_PROMPTS, LM_PROMPT_LEN, LM_STEPS = 8, 128, 32
LM_TOL = 2e-2           # bf16 tolerance, a share of max|x| (a few ulps)
PEAK_BF16 = 989e12      # H100 SXM bf16 tensor-core FLOP/s, dense


def lm_tokens(seqs, vocab: int, width: int = LM_WIDTH) -> np.ndarray:
    """``examples/pattern_search.py``'s byte tokens at ``width`` (spaces
    pad a short record); the modulus is taken in int32, since a uint8
    array cannot hold a vocabulary of 151,936."""
    return np.stack([np.frombuffer(s[:width].ljust(width).encode(),
                                   dtype=np.uint8).astype(np.int32) % vocab
                     for s in seqs])


def lm_requests(vectors, seqs, rng):
    """``examples/pattern_search.py``'s request sets, drawn from ``rng``
    in its order: 120 sampled CONTAINS patterns, 11 boolean/LIKE
    predicates, the records' (genre, price) attributes, 10 tag + range
    (+ pattern) predicates; each request a record's vector plus 0.1·N(0,
    1) noise, k = 10."""
    from repro_torch.core.predicate import quote_literal
    from repro_torch.data.corpora import sample_patterns
    from repro_torch.serve.engine import Request

    def noisy(p):
        return Request(vector=vectors[rng.integers(len(vectors))]
                       + 0.1 * rng.standard_normal(vectors.shape[1]
                                                   ).astype(np.float32),
                       pattern=p, k=K)

    def esc(text):
        return (text.replace("\\", "\\\\").replace("%", r"\%")
                .replace("_", r"\_"))

    contains = [noisy(p) for p in (sample_patterns(seqs, 2, 40, seed=11)
                                   + sample_patterns(seqs, 3, 40, seed=11)
                                   + sample_patterns(seqs, 4, 40, seed=11))]
    p2 = sample_patterns(seqs, 2, 8, seed=23)
    p3 = sample_patterns(seqs, 3, 8, seed=23)
    long_seqs = [s for s in seqs if len(s) >= 8]
    q = quote_literal
    boolean = [noisy(p) for p in (
        [f"{q(a)} AND {q(b)}" for a, b in zip(p2[:3], p3[:3])]
        + [f"{q(a)} OR {q(b)}" for a, b in zip(p3[:3], p3[3:6])]
        + [f"{q(a)} AND NOT {q(b)}" for a, b in zip(p2[3:5], p3[5:7])]
        + [f"LIKE {q('%' + esc(s[:3]) + '%' + esc(s[-3:]) + '%')}"
           for s in long_seqs[:3]])]
    genres = ["rock", "jazz", "pop"]
    attributes = [{"genre": genres[int(rng.integers(0, 3))],
                   "price": float(np.round(rng.uniform(0, 20), 2))}
                  for _ in seqs]
    hybrid = [noisy(p) for p in (
        [f"genre = {q(g)}" for g in genres]
        + ["price < 5", "price >= 3 AND price <= 12"]
        + [f"{q(p)} AND genre = 'jazz'" for p in p2[:2]]
        + [f"{q(p)} AND price < 10" for p in p3[:2]])]
    return {"contains": contains, "boolean": boolean,
            "hybrid": hybrid}, attributes


def build_lm_index(vectors, seqs, attributes, path: str) -> None:
    """Run in a child process: build the index of the LM's embeddings on
    the host (the ESAM and one HNSW per state above T — NumPy work that
    never touches the card) and checkpoint it to ``path``; the build's
    seconds go to ``path + ".json"``.  The parent restores it onto the
    card."""
    from repro_torch.core.vectormaton import VectorMatonConfig
    from repro_torch.serve.engine import RetrievalEngine
    t0 = time.perf_counter()
    engine = RetrievalEngine(vectors, seqs, VectorMatonConfig(
        backend="numpy", schema=LM_SCHEMA, **LM_INDEX),
        attributes=attributes)
    build_s = time.perf_counter() - t0
    engine.checkpoint(path)
    Path(path + ".json").write_text(json.dumps({"build_s": build_s}))


class LMRun:
    """What the early part of the LM phase hands the late part: the
    corpus, its embeddings, the request sets and, once ``start()`` ran,
    the child process that builds the index.  ``stop()`` ends the child
    and removes its checkpoint directory."""

    def __init__(self, seqs, vectors, requests, attributes):
        import tempfile
        self.seqs, self.vectors = seqs, vectors
        self.requests, self.attributes = requests, attributes
        self.tmp = tempfile.mkdtemp(prefix="lm_index_")
        self.path = str(Path(self.tmp) / "index")
        self.proc = None

    def start(self) -> None:
        import multiprocessing
        self.proc = multiprocessing.get_context("spawn").Process(
            target=build_lm_index, args=(self.vectors, self.seqs,
                                         self.attributes, self.path))
        self.t_start = time.perf_counter()
        self.proc.start()

    def wait(self) -> dict:
        """Join the build; its seconds, and how long the parent waited."""
        t0 = time.perf_counter()
        self.proc.join()
        check(self.proc.exitcode == 0,
              f"the LM index build failed (exit {self.proc.exitcode})")
        out = json.loads(Path(self.path + ".json").read_text())
        out["waited_s"] = time.perf_counter() - t0
        out["started_to_done_s"] = time.perf_counter() - self.t_start
        return out

    def stop(self) -> None:
        import shutil
        if self.proc is not None:
            if self.proc.is_alive():
                self.proc.terminate()
            self.proc.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase_lm_model(card: str):
    """qwen3-4b at its published width and depth in bf16, random weights
    from a seeded generator on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    check(n == cfg.param_count() + pad,
          f"{n} parameters, cfg.param_count() {cfg.param_count()} + {pad}")
    emit(phase="lm_model", card=card, arch=cfg.name,
         layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, vocab_padded=model.vocab_padded,
         dtype=cfg.dtype, params=n, param_count=cfg.param_count(),
         padded_vocab_params=pad,
         device_bytes=sum(p.numel() * p.element_size()
                          for p in model.parameters()), init_s=init_s)
    return model


def _smoke_run(model, cfg, toks, extra, steps, feed=None):
    """Prefill and ``steps`` greedy decode steps on the model's device:
    (logits per step (host fp32), tokens fed).  ``feed``: the tokens to
    feed instead of the model's own argmax (the CPU run's)."""
    dev = model.device
    t = torch.from_numpy(toks).to(dev)
    if cfg.is_encoder_decoder:
        cache, logits = model.prefill(torch.from_numpy(extra).to(dev), t,
                                      toks.shape[1] + steps)
        pos = toks.shape[1]
    else:
        pe = None if extra is None else torch.from_numpy(extra).to(dev)
        n_pre = 0 if extra is None else extra.shape[1]
        cache, logits = model.prefill(t, toks.shape[1] + n_pre + steps,
                                      patch_embeds=pe)
        pos = toks.shape[1] + n_pre
    out, fed = [host(logits.float())], []
    for i in range(steps):
        nxt = out[-1].argmax(-1) if feed is None else feed[i]
        fed.append(nxt)
        logits, cache = model.decode_step(
            cache, torch.from_numpy(nxt[:, None]).to(dev), pos + i)
        out.append(host(logits.float()))
    return out, fed


def _near_tie_tokens(got, logits, tol):
    """``got`` (B,) equals ``logits``' argmax except where the two tokens'
    logits are within ``tol``; returns the near ties' logit gaps."""
    want = logits.argmax(-1)
    gaps = []
    for i in np.nonzero(got != want)[0]:
        gap = float(logits[i, want[i]] - logits[i, got[i]])
        check(gap <= tol, f"token {got[i]} vs argmax {want[i]}: gap {gap} "
              f"> {tol}")
        gaps.append(gap)
    return gaps


def phase_lm_parity(card: str) -> None:
    """The card against the port's own CPU path on the same weights: the
    full-width qwen3-4b config cut to 2 layers (bf16 hidden states), and
    every architecture's smoke config in fp32 (prefill + 8 decode
    steps)."""
    from repro_torch.configs import arch_names, get_config, smoke_config
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import LM
    rng = np.random.default_rng(5)
    cfg = get_config(LM_ARCH).replace(num_layers=2)
    model = LM(cfg, device="cuda", seed=1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, LM_WIDTH)))
    t0 = time.perf_counter()
    h_card = host(model.forward(toks.cuda())[0].float())
    model.to("cpu")
    h_cpu = host(model.forward(toks)[0].float())
    err = np.abs(h_card - h_cpu)
    scale = float(np.abs(h_cpu).max())
    check(err.max() <= LM_TOL * scale,
          f"2-layer hidden states differ by {err.max()} > {LM_TOL}·{scale}")
    emit(phase="lm_parity", card=card, case=f"{LM_ARCH} 2 layers, bf16",
         shape=list(h_cpu.shape), max_abs_err=float(err.max()),
         mean_abs_err=float(err.mean()), max_abs=scale,
         tol=LM_TOL * scale, seconds=time.perf_counter() - t0)
    del model
    steps, results = 8, {}
    for name in arch_names():
        scfg = smoke_config(name)
        model = (EncDec if scfg.is_encoder_decoder else LM)(
            scfg, device="cpu", seed=0)
        toks = rng.integers(0, scfg.vocab_size, (2, 16)).astype(np.int64)
        extra = None
        if scfg.is_encoder_decoder:
            extra = (0.1 * rng.standard_normal((2, 24, scfg.d_model))
                     ).astype(np.float32)
        elif scfg.frontend == "vision_stub":
            extra = (0.1 * rng.standard_normal(
                (2, scfg.num_patches, scfg.d_model))).astype(np.float32)
        cpu, fed = _smoke_run(model, scfg, toks, extra, steps)
        model.to("cuda")
        card_out, _ = _smoke_run(model, scfg, toks, extra, steps, feed=fed)
        worst, ties = 0.0, 0
        for i, (a, b) in enumerate(zip(card_out, cpu)):
            tol = 1e-3 * float(np.abs(b).max())
            e = float(np.abs(a - b).max())
            check(e <= tol, f"{name} step {i}: logits differ by {e} > {tol}")
            worst = max(worst, e / max(float(np.abs(b).max()), 1e-30))
            ties += len(_near_tie_tokens(a.argmax(-1), b, 2 * tol))
        results[name] = {"max_rel_err": worst, "near_ties": ties}
        del model
    emit(phase="lm_parity", card=card, case="smoke configs, fp32",
         steps=steps, tol="1e-3·max|logit|", archs=results)
    torch.cuda.empty_cache()


def phase_lm_embed(model, card: str) -> "LMRun":
    """Embed every record of ``make_corpus("mtg")`` with ``embed_texts``
    and draw the request sets."""
    from repro_torch.data.corpora import make_corpus
    from repro_torch.serve.engine import embed_texts
    cfg = model.cfg
    _, seqs = make_corpus("mtg", scale=1.0)
    batches = [lm_tokens(seqs[i:i + LM_BATCH], cfg.vocab_size)
               for i in range(0, len(seqs), LM_BATCH)]
    embed_texts(model, batches[:1])           # warm-up (cuBLAS, allocator)
    torch.cuda.reset_peak_memory_stats()
    ms, parts = [], []
    for b in batches:
        t0 = time.perf_counter()
        parts.append(embed_texts(model, [b]))   # ends in a copy to host
        ms.append((time.perf_counter() - t0) * 1e3)
    vectors = np.concatenate(parts).astype(np.float32)
    check(vectors.shape == (len(seqs), cfg.d_model),
          f"embeddings {vectors.shape}")
    check(bool(np.isfinite(vectors).all()), "non-finite embeddings")
    norms = np.linalg.norm(vectors, axis=1)
    tokens = len(seqs) * LM_WIDTH
    flop = 2 * tokens * sum(p.numel() for name, p in
                            model.named_parameters() if name != "embed")
    seconds = sum(ms) / 1e3
    emit(phase="lm_embed", card=card, records=len(seqs), tokens=tokens,
         width=LM_WIDTH, batch=LM_BATCH, batches=len(batches),
         seconds=seconds, tokens_per_s=tokens / seconds,
         ms_per_batch_p50=float(np.median(ms)),
         ms_per_batch_max=float(np.max(ms)),
         gemm_flop=flop, achieved_tflops=flop / seconds / 1e12,
         bound_s=flop / PEAK_BF16,
         peak_memory_allocated=torch.cuda.max_memory_allocated(),
         norm_min=float(norms.min()), norm_mean=float(norms.mean()),
         norm_max=float(norms.max()))
    requests, attributes = lm_requests(vectors, seqs,
                                       np.random.default_rng(1))
    return LMRun(seqs, vectors, requests, attributes)


def phase_lm_generate(model, card: str) -> None:
    """8 prompts of 128 tokens: one prefill, 32 greedy decode steps; each
    step's token held to the argmax of a full-sequence ``forward`` over
    the prompt and the tokens so far at steps 1, 16 and 32."""
    from repro_torch.serve.step import make_decode, make_prefill
    cfg = model.cfg
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN))).cuda()
    max_len = LM_PROMPT_LEN + LM_STEPS
    prefill, decode = make_prefill(model, max_len), make_decode(model)
    prefill(prompts)                          # warm-up at this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, nxt = prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    gen, step_ms = [nxt[:, None]], []
    for i in range(LM_STEPS):
        t0 = time.perf_counter()
        nxt, cache = decode(cache, gen[-1], LM_PROMPT_LEN + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gen.append(nxt)
    gen = torch.cat(gen, dim=1)                          # (B, 1 + steps)
    ties, tol = {}, {}
    for t in (0, 1, 16, LM_STEPS):
        seq = torch.cat([prompts, gen[:, :t]], dim=1)
        hidden, _, _ = model.forward(seq)
        logits = host(model.logits(hidden[:, -1]))
        tol[t] = LM_TOL * float(np.abs(logits).max())
        ties[t] = _near_tie_tokens(host(gen[:, t]), logits, tol[t])
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    LM_GENERATED.update(gen=host(gen), prefill_ms=prefill_ms,
                        step_ms=step_ms)
    emit(phase="lm_generate", card=card, prompts=LM_PROMPTS,
         prompt_len=LM_PROMPT_LEN, max_len=max_len, steps=LM_STEPS,
         prefill_ms=prefill_ms,
         prefill_tokens_per_s=LM_PROMPTS * LM_PROMPT_LEN / prefill_ms * 1e3,
         decode_ms_per_token_p50=float(np.median(step_ms)),
         decode_ms_p25_p75=np.percentile(step_ms, [25, 75]).tolist(),
         decode_tokens_per_s=LM_PROMPTS / float(np.median(step_ms)) * 1e3,
         decode_bound_ms=weight_bytes / PEAK_BYTES * 1e3,
         consistency_steps=sorted(ties), near_tie_gaps=ties,
         near_tie_tol=tol)


LM_GENERATED = {}        # lm_generate's tokens and times, for serve_tp_full


def phase_lm_profile(card: str) -> None:
    """One decode step of the same model (re-made from its seed) under
    ``torch.profiler``: the device's busy share of a step.  It runs last:
    once the profiler has traced a process, later launches from it cost
    the host more, and the LM's first part runs before the phases whose
    host-bound times this script reports."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve.step import make_decode, make_prefill
    cfg = get_config(LM_ARCH)
    model = LM(cfg, device="cuda", seed=0)
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN))).cuda()
    cache, nxt = make_prefill(model, LM_PROMPT_LEN + 2)(prompts)
    decode = make_decode(model)
    nxt, cache = decode(cache, nxt[:, None], LM_PROMPT_LEN)   # warm-up
    wall_ms, busy, top = device_profile(
        lambda: decode(cache, nxt, LM_PROMPT_LEN + 1))
    emit(phase="lm_generate_profile", card=card, step_wall_ms=wall_ms,
         step_device_busy_ms=busy,
         step_idle_share=None if busy is None else 1 - busy / wall_ms,
         top=top[:6])
    del model, cache
    torch.cuda.empty_cache()


def phase_lm_serve(card: str, run: "LMRun"):
    """The index of the embeddings, restored onto the card from the
    child's checkpoint, serves the three request sets under ``sq8`` and
    ``none``; returns kernel A's and B's launches and their measurements
    at this shape."""
    from repro_torch.core import hnsw_torch
    from repro_torch.core.baselines import ground_truth, recall
    from repro_torch.core.predicate import parse_predicate
    from repro_torch.core.vectormaton import VectorMatonConfig
    from repro_torch.kernels import distance_topk, quant
    from repro_torch.serve.engine import RetrievalEngine
    build = run.wait()
    config = VectorMatonConfig(backend="torch", device="cuda",
                               schema=LM_SCHEMA, **LM_INDEX)
    t0 = time.perf_counter()
    engine = RetrievalEngine.restore(run.path, config=config,
                                     device="cuda")
    rt = engine.index.runtime
    dev_vecs = rt.to_device()["vectors"]
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    emit(phase="lm_index", card=card, n=len(run.seqs),
         d=run.vectors.shape[1], **LM_INDEX, states=rt.stats()["states"],
         graph_states=len(rt.graphs), restore_s=restore_s, **build)

    seqs, attrs = run.seqs, run.attributes
    # every beam call of this phase, all on the card, launches beam_f32
    beams0, calls0 = hnsw_torch.beam_f32.launches, graph_beam_calls()
    for mode in ("sq8", "none"):              # warm-up wave per mode
        rt.quantize = mode
        engine.serve_batch(run.requests["contains"][:8])
    distance_topk.topk_seg_f32.launches = 0
    quant.qtopk_seg_sq8.launches = 0
    distance_topk.reset_tile_stats()
    waves0 = hnsw_torch.beam_f32.launches
    answers, wave_ms = {}, {}
    with Capture(distance_topk, "topk_seg_f32") as cap_a, \
            Capture(quant, "qtopk_seg_sq8") as cap_b:
        for mode in ("sq8", "none"):
            rt.quantize = mode
            rt._sq8_bad_streak = 0        # so sq8 waves run the SQ8 scan
            for name, reqs in run.requests.items():
                t0 = time.perf_counter()
                answers[(mode, name)] = engine.serve_batch(reqs)
                torch.cuda.synchronize()
                wave_ms[f"{mode}/{name}"] = (time.perf_counter() - t0) * 1e3
    launches_a = distance_topk.topk_seg_f32.launches
    launches_b = quant.qtopk_seg_sq8.launches
    launches_beam = hnsw_torch.beam_f32.launches - waves0
    tiles_a = distance_topk.tile_stats()
    tiles_b = distance_topk.tile_stats("qtopk_seg_sq8")
    check(launches_a > 0, "kernel A never launched on the LM path")
    check(launches_b > 0, "kernel B never launched on the LM path")

    checked, free_total, graph_recalls = 0, 0, []
    for name, reqs in run.requests.items():
        patterns = [r.pattern for r in reqs]
        queries = np.stack([r.vector for r in reqs]).astype(np.float32)
        free = _graph_free_requests(engine.index, patterns)
        rows_of = matching_rows(seqs, patterns, attrs)
        oracle = brute_force(dev_vecs, rows_of, queries, patterns, K)
        for mode in ("sq8", "none"):
            got = answers[(mode, name)]
            for r, (req, resp) in enumerate(zip(reqs, got)):
                pred = parse_predicate(req.pattern)
                for i in resp.ids.tolist():
                    check(pred.matches(seqs[i], attrs[i]),
                          f"{mode}/{name}: id {i} fails {req.pattern!r}")
                    checked += 1
            rec = recall_check([(got[r].distances, got[r].ids)
                                for r in free], [oracle[r] for r in free])
            check(rec == 1.0, f"{mode}/{name}: graph-free recall {rec}")
        free_total += len(free)
        if name == "contains":                  # the example's recall
            graph = sorted(set(range(len(reqs))) - set(free))
            graph_recalls = [recall(answers[("none", name)][r].ids,
                                    ground_truth(engine.index.vectors,
                                                 engine.index.esam,
                                                 reqs[r].pattern,
                                                 reqs[r].vector, K))
                             for r in graph]

    # checkpoint the served engine, restore it, the same answers
    import tempfile
    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as tmp:
        t0 = time.perf_counter()
        engine.checkpoint(str(Path(tmp) / "engine"))
        save_s = time.perf_counter() - t0
        back = RetrievalEngine.restore(str(Path(tmp) / "engine"),
                                       config=config, device="cuda")
        for e in (engine, back):
            e.index.runtime.quantize = "none"
        for name, reqs in run.requests.items():
            a, b = engine.serve_batch(reqs), back.serve_batch(reqs)
            check(all(np.array_equal(x.ids, y.ids)
                      and np.array_equal(x.distances, y.distances)
                      for x, y in zip(a, b)),
                  f"{name}: the restored engine answers differently")
    beams = hnsw_torch.beam_f32.launches - beams0
    calls = graph_beam_calls() - calls0
    check(beams == calls > 0 and launches_beam > 0,
          f"beam_f32 launched {beams} times for {calls} beam calls "
          f"({launches_beam} in the timed waves)")
    # the beam at the LM's width: the request sets' beam calls again, on
    # integer data of their shapes, bit-equal to _beam
    _, recorded = _beam_ranges()
    try:
        for reqs in run.requests.values():
            engine.serve_batch(reqs)
    finally:
        _beam_ranges(restore=True)
    beam_int = beam_int_check([c for n in _BEAMS for c in recorded[n]],
                              seed=11)
    emit(phase="lm_serve", card=card, k=K,
         requests={n: len(r) for n, r in run.requests.items()},
         graph_free=free_total, ids_checked=checked,
         graph_free_recall=1.0,
         contains_graph_state_requests=len(graph_recalls),
         contains_graph_state_recall_mean=(float(np.mean(graph_recalls))
                                           if graph_recalls else None),
         wave_ms=wave_ms,
         kernel_launches={"topk_seg_f32": launches_a,
                          "qtopk_seg_sq8": launches_b,
                          "beam_f32": launches_beam},
         beam_calls_in_phase=calls,
         kernel_a_tiles=tiles_a, kernel_b_tiles=tiles_b,
         sq8_stats=dict(rt.sq8_stats), checkpoint_save_s=save_s,
         restored_answers_equal=True, beam_integer_checks=beam_int)
    a = measure_kernel_a(*cap_a.args, launches_a, tiles_a)
    b = measure_kernel_b(cap_b.args[0], launches_b, tiles_b)
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "composition_ms", "shape", "tiles_one_call")
    emit(phase="lm_kernels", card=card,
         kernels={m["name"]: {k: m[k] for k in keep} for m in (a, b)})
    return ({"topk_seg_f32": launches_a, "qtopk_seg_sq8": launches_b,
             "beam_f32": launches_beam},
            {m["name"]: {k: m[k] for k in keep} for m in (a, b)})


# --------------------------------------------------------------------- #
# training — qwen3-4b's train step, and examples/train_embedder.py's flow
# --------------------------------------------------------------------- #

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 8, 128   # the launcher's defaults
TRAIN_WARM = 2          # steps 1-2 warm cuBLAS and the allocator
GRAD_TOL = 2 ** -5       # 4 bf16 ulps of a leaf's largest gradient
EMBEDDER = dict(name="mamba2-100m", num_layers=12, ssm_chunk=64,
                vocab_size=8192, dtype="float32")
EMBEDDER_STEPS, EMBEDDER_CKPT_EVERY = 150, 50


def _grads(model, batch):
    """(loss, {name: fp32 host gradient}) of ``model.loss`` on its
    device."""
    model.requires_grad_(True)
    loss = model.loss(batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: host(g.float())
                                  for k, g in zip(names, grads)}


def _adam_rule(got, want, grads, lr):
    """Parameters after a step, card against CPU: elements whose CPU
    gradient exceeds 1e-4·max|g| of their leaf within rtol 1e-5 + atol
    1e-6; the others (Adam's first step is about lr·sign(g), and a
    gradient at rounding noise may flip) within 2·lr.  Returns the count
    of the others and the worst error of the tight ones."""
    loose, worst = 0, 0.0
    for k, w in want.items():
        g = np.abs(grads[k])
        tight = g > 1e-4 * g.max()
        err = np.abs(got[k] - w)
        lim = 1e-6 + 1e-5 * np.abs(w)
        check(bool((err[tight] <= lim[tight]).all()),
              f"{k}: tight elements off (max error {err.max()})")
        check(bool((err[~tight] <= 2 * lr + 1e-6).all()),
              f"{k}: loose elements off by more than 2·lr")
        loose += int((~tight).sum())
        if tight.any():
            worst = max(worst, float((err[tight] / lim[tight]).max()))
    return loose, worst


def phase_train_parity(card: str) -> None:
    """The card against the port's own CPU path on the same weights: the
    full-width qwen3-4b config cut to 2 layers in bf16 (the loss, the
    global grad norm and every leaf's gradient), and every
    architecture's smoke config in fp32 (one full train step)."""
    from repro_torch.configs import arch_names, get_config, smoke_config
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    rng = np.random.default_rng(13)
    cfg = get_config(LM_ARCH).replace(num_layers=2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, LM_WIDTH)
                                    ).astype(np.int32)}
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda", seed=1)
    loss_card, g_card = _grads(model, batch)
    model.to("cpu")
    loss_cpu, g_cpu = _grads(model, batch)
    del model
    norm = lambda g: float(np.sqrt(sum(float((x.astype(np.float64) ** 2
                                              ).sum()) for x in g.values())))
    n_card, n_cpu = norm(g_card), norm(g_cpu)
    check(abs(loss_card - loss_cpu) <= 1e-3 * abs(loss_cpu),
          f"2-layer loss {loss_card} vs {loss_cpu}")
    check(abs(n_card - n_cpu) <= GRAD_TOL * n_cpu,
          f"2-layer grad norm {n_card} vs {n_cpu}")
    leaf_err = {}
    for k, want in g_cpu.items():
        scale = float(np.abs(want).max())
        e = float(np.abs(g_card[k] - want).max())
        check(e <= GRAD_TOL * scale, f"grad {k}: {e} > {GRAD_TOL}·{scale}")
        leaf_err[k] = e / max(scale, 1e-30)
    worst = max(leaf_err, key=leaf_err.get)
    emit(phase="train_parity", card=card, case=f"{LM_ARCH} 2 layers, bf16",
         tokens=[4, LM_WIDTH], loss_card=loss_card, loss_cpu=loss_cpu,
         grad_norm_card=n_card, grad_norm_cpu=n_cpu, leaves=len(leaf_err),
         max_rel_grad_err=leaf_err[worst], worst_leaf=worst,
         embed_rel_grad_err=leaf_err["embed"],
         tol=f"{GRAD_TOL}·max|g| a leaf, loss 1e-3 relative",
         seconds=time.perf_counter() - t0)
    del g_card, g_cpu

    results = {}
    lr = 1e-3
    for name in arch_names():
        scfg = smoke_config(name)
        b = {"tokens": rng.integers(0, scfg.vocab_size, (2, 16)
                                    ).astype(np.int32)}
        if scfg.is_encoder_decoder:
            b["frames"] = (0.1 * rng.standard_normal((2, 24, scfg.d_model))
                           ).astype(np.float32)
        elif scfg.frontend == "vision_stub":
            b["patch_embeds"] = (0.1 * rng.standard_normal(
                (2, scfg.num_patches, scfg.d_model))).astype(np.float32)
        runs = []
        for dev in ("cpu", "cuda"):
            model = (EncDec if scfg.is_encoder_decoder else LM)(
                scfg, device="cpu", seed=0).to(dev)
            seen = []
            step = make_train_step(
                model, opt.OptConfig(lr=lr),
                grad_transform=lambda g: seen.append(g) or g)
            m = step(opt.init(dict(model.named_parameters())), b)
            runs.append((float(m["loss"]),
                         {k: host(p) for k, p in model.named_parameters()},
                         {k: host(g) for k, g in seen[0].items()}))
        (l_cpu, p_cpu, g_cpu), (l_card, p_card, _) = runs
        check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
              f"{name}: loss {l_card} vs {l_cpu}")
        loose, worst = _adam_rule(p_card, p_cpu, g_cpu, lr)
        results[name] = {"loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
                         "loose_elements": loose,
                         "tight_worst_share_of_tol": worst}
    emit(phase="train_parity", card=card, case="smoke configs, fp32",
         tol="loss 1e-4 relative; Adam rule (tight: rtol 1e-5 + atol "
             "1e-6 where |g| > 1e-4·max|g|, else 2·lr)", lr=lr,
         archs=results)
    torch.cuda.empty_cache()


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 · parameters · tokens, plus the
    attention products (QKᵀ and PV over the full S × S square the port
    computes, forward and backward: 12 · L · B · S² · H · hd).  The
    remat recompute is not counted."""
    attn = 12 * cfg.num_layers * batch * seq * seq * cfg.num_heads \
        * cfg.head_dim
    return 6.0 * n_params * batch * seq + attn


def train_full_child(card: str, results=None) -> None:
    """``repro_torch.launch.train`` on qwen3-4b at full width and depth
    (its defaults: bf16, remat, batch 8 × seq 128), 10 steps, run in its
    own process; the optimizer's update is timed apart with CUDA events
    around ``optimizer.update``; one more step under the profiler last.
    Puts the line's numbers on the queue ``results`` too."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    update, spans = opt.update, []

    def timed_update(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = update(*args, **kwargs)
        ev[1].record()
        spans.append(ev)
        return out

    opt.update = timed_update
    args = launch_train.parse_args(
        ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--log-every", "1"])
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run = launch_train.run(args)
    wall_s = time.perf_counter() - t0
    opt.update = update
    peak = torch.cuda.max_memory_allocated()
    hist = run.history
    losses = [h["loss"] for h in hist]
    gnorms = [float(h["metrics"]["grad_norm"]) for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite train metrics: {losses} {gnorms}")
    upd_ms = [s.elapsed_time(e) for s, e in spans]
    steady = [h["ms"] for h in hist[TRAIN_WARM:]]
    step_ms = float(np.median(steady))
    model, cfg = run.model, run.cfg
    n = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop = train_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    state_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters()) + sum(
        t.numel() * t.element_size() for part in ("m", "v")
        for t in run.opt_state[part].values())
    # the update reads each parameter, gradient and moment once and
    # writes each parameter and moment once
    update_bytes = sum(
        3 * p.element_size() * p.numel() for p in model.parameters()
    ) + 2 * sum(t.numel() * t.element_size() for part in ("m", "v")
                for t in run.opt_state[part].values())
    fresh = LM(cfg, device="cuda", seed=0)
    changed = sum(bool((p != q).any()) for p, q in
                  zip(model.parameters(), fresh.parameters()))
    del fresh
    torch.cuda.empty_cache()
    check(changed == len(list(model.parameters())),
          f"{changed} of {len(list(model.parameters()))} leaves changed")
    if results is not None:
        results.put({"loss": losses, "step_ms_p50": step_ms,
                     "tokens_per_s": tokens / step_ms * 1e3,
                     "mfu": flop / (step_ms / 1e3) / PEAK_BF16,
                     "peak_memory_allocated": peak})
    batch = run.pipe.batch_at(TRAIN_STEPS)
    prof = {}
    wall_ms, busy, top = device_profile(
        lambda: run.step_fn(run.opt_state, batch), prof)
    emit(phase="train_full", card=card, arch=cfg.name,
         layers=cfg.num_layers, d_model=cfg.d_model, dtype=cfg.dtype,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, params=n,
         state_bytes=state_bytes, loss=losses, grad_norm=gnorms,
         lr=[float(h["metrics"]["lr"]) for h in hist],
         step_ms=[h["ms"] for h in hist],
         step_ms_p50=step_ms, step_ms_steps=f"{TRAIN_WARM + 1}-{TRAIN_STEPS}",
         tokens_per_s=tokens / step_ms * 1e3, model_flop=flop,
         model_tflops=flop / step_ms / 1e9,
         mfu=flop / (step_ms / 1e3) / PEAK_BF16,
         flop_bound_ms=flop / PEAK_BF16 * 1e3,
         update_ms=upd_ms, update_ms_p50=float(np.median(upd_ms[TRAIN_WARM:])),
         update_bound_ms=update_bytes / PEAK_BYTES * 1e3,
         peak_memory_allocated=peak, leaves_changed=changed,
         run_s=wall_s, log=log.getvalue().splitlines(),
         profiled_step_wall_ms=wall_ms, profiled_step_busy_ms=busy,
         profiled_step_idle_share=None if busy is None
         else 1 - busy / wall_ms,
         kernels_per_step=prof["device_kernels"],
         launch_calls={k: v["count"] for k, v in prof.items()
                       if k != "device_kernels"}, top=top)


def run_child(target, card: str, name: str):
    """``target(card, queue)`` in a spawned process, so that the earlier
    phases' tensors and host state share neither its memory nor its
    host; it prints its own line and fails the run if it fails.
    Returns what it put on the queue."""
    import multiprocessing
    import queue as queue_mod
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=target, args=(card, results))
    t0 = time.perf_counter()
    proc.start()
    out = None
    while out is None and (proc.is_alive() or not results.empty()):
        try:
            out = results.get(timeout=1.0)
        except queue_mod.Empty:
            pass
    proc.join()
    check(proc.exitcode == 0 and out is not None,
          f"{name} failed (exit {proc.exitcode})")
    emit(phase=f"{name}_done", seconds=time.perf_counter() - t0)
    return out


TRAIN_RESULTS = {}      # train_full's numbers, for train_dp_full


def phase_train_full(card: str) -> None:
    """``train_full_child`` in a spawned process."""
    TRAIN_RESULTS["train_full"] = run_child(train_full_child, card,
                                            "train_full")


def phase_train_embedder(card: str) -> None:
    """``examples/train_embedder.py`` on the card at its own size:
    mamba2-370m cut to 12 layers, vocab 8,192, fp32, SSD chunk 64, 150
    steps of 8 × 128 with AdamW (lr 3e-3, warmup 20); async checkpoints
    at steps 50 and 100 and a final one (keep 2); the loss must drop;
    a restore into a fresh model and one more step.  Then 3 steps, a
    checkpoint, a restore and 3 more against 6 uninterrupted steps."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.elastic import StragglerMonitor
    from repro_torch.models.convert import (from_reference_state,
                                            to_reference_state)
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    cfg = get_config("mamba2-370m").replace(**EMBEDDER)
    steps = EMBEDDER_STEPS
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tmp = tempfile.mkdtemp(prefix="embedder_ckpt_")
    ckpt = CheckpointManager(tmp, keep=2)
    write_s = []
    write = ckpt._write

    def timed_write(step, flat):
        t0 = time.perf_counter()
        write(step, flat)
        write_s.append(time.perf_counter() - t0)

    ckpt._write = timed_write
    try:
        model = LM(cfg, device="cuda", seed=0)
        n = sum(p.numel() for p in model.parameters())
        params = dict(model.named_parameters())
        step_fn = make_train_step(model, ocfg, remat=True)
        ostate = opt.init(params)
        straggler = StragglerMonitor()
        losses, ms, saves = [], [], []
        for step in range(steps):
            t0 = time.perf_counter()
            m = step_fn(ostate, pipe.batch_at(step))
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            straggler.record("host0", ms[-1] / 1e3)
            if step and step % EMBEDDER_CKPT_EVERY == 0:
                t0 = time.perf_counter()
                ckpt.save(step, to_reference_state(cfg, params, ostate),
                          blocking=False)
                saves.append({"step": step,
                              "call_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        ckpt.save(steps, to_reference_state(cfg, params, ostate))
        ckpt.wait()
        saves.append({"step": steps, "call_s": time.perf_counter() - t0})
        for s, w in zip(saves, write_s):
            s["write_s"] = w
        kept = ckpt.all_steps()
        for s in saves:
            if s["step"] in kept:
                s["bytes"] = sum(f.stat().st_size for f in
                                 (Path(tmp) / f"step_{s['step']:010d}"
                                  ).iterdir())
        check(all(np.isfinite(losses)), "non-finite embedder loss")
        check(losses[-1] < losses[0], f"loss did not improve: "
              f"{losses[0]} -> {losses[-1]}")
        last_async = (steps - 1) // EMBEDDER_CKPT_EVERY * EMBEDDER_CKPT_EVERY
        check(kept == [last_async, steps], f"checkpoints kept {kept}")
        t0 = time.perf_counter()
        sd, o2 = from_reference_state(cfg, ckpt.restore(device="cuda"))
        fresh = LM(cfg, device="cuda", seed=1)
        fresh.load_state_dict(sd)
        restore_s = time.perf_counter() - t0
        m = make_train_step(fresh, ocfg, remat=True)(o2,
                                                     pipe.batch_at(steps))
        resumed = float(m["loss"])
        check(int(o2["step"]) == steps + 1 and np.isfinite(resumed),
              f"resumed step {int(o2['step'])}, loss {resumed}")
        del model, fresh, ostate, o2, params, step_fn
        torch.cuda.empty_cache()
        resume = _resume_equivalence(cfg, pipe, tmp)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    steady = ms[TRAIN_WARM:]
    emit(phase="train_embedder", card=card, arch=cfg.name,
         layers=cfg.num_layers, vocab=cfg.vocab_size, params=n,
         steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         loss_first=losses[0], loss_last=losses[-1],
         loss_every_50=losses[::50], step_ms_p50=float(np.median(steady)),
         step_ms_p25_p75=np.percentile(steady, [25, 75]).tolist(),
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / float(np.median(steady))
         * 1e3, run_s=sum(ms) / 1e3, checkpoints=saves, kept=kept,
         restore_s=restore_s, resumed_step=steps + 1, resumed_loss=resumed,
         stragglers=straggler.stragglers(), resume_equivalence=resume)


def _resume_equivalence(cfg, pipe, tmp):
    """6 uninterrupted steps against 3, a checkpoint, a restore into a
    fresh model and optimizer, and 3 more, on the card: every parameter
    within atol 1e-5 + rtol 1e-4 (the reference test's tolerance; the
    card's embedding backward accumulates with atomics, so two runs need
    not agree bit for bit)."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.models.convert import (from_reference_state,
                                            to_reference_state)
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    ocfg = opt.OptConfig(lr=1e-3)

    def fresh(sd=None):
        model = LM(cfg, device="cuda", seed=2)
        if sd is not None:
            model.load_state_dict(sd)
        return model, make_train_step(model, ocfg)

    m1, step1 = fresh()
    o1 = opt.init(dict(m1.named_parameters()))
    for i in range(6):
        step1(o1, pipe.batch_at(i))
    want = {k: host(p) for k, p in m1.named_parameters()}
    del m1, o1, step1
    m2, step2 = fresh()
    o2 = opt.init(dict(m2.named_parameters()))
    for i in range(3):
        step2(o2, pipe.batch_at(i))
    mgr = CheckpointManager(str(Path(tmp) / "resume"))
    mgr.save(3, to_reference_state(cfg, dict(m2.named_parameters()), o2))
    del m2, o2, step2
    sd, o3 = from_reference_state(cfg, mgr.restore(3, device="cuda"))
    m3, step3 = fresh(sd)
    for i in range(3, 6):
        step3(o3, pipe.batch_at(i))
    worst, exact = 0.0, True
    for k, p in m3.named_parameters():
        got = host(p)
        err = np.abs(got - want[k])
        lim = 1e-5 + 1e-4 * np.abs(want[k])
        check(bool((err <= lim).all()),
              f"resumed {k} off by {err.max()} (> atol 1e-5 + rtol 1e-4)")
        worst = max(worst, float(err.max()))
        exact = exact and bool((err == 0).all())
    del m3, o3
    torch.cuda.empty_cache()
    return {"steps": "3 + checkpoint + restore + 3 vs 6",
            "max_abs_err": worst, "bit_equal": exact,
            "tol": "atol 1e-5 + rtol 1e-4"}


# --------------------------------------------------------------------- #
# data-parallel training — the step over a data mesh, and compressed_psum
# --------------------------------------------------------------------- #

DP_ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b")   # at 2 layers, full width
DP_SHARDS = (2, 4)
DP_BATCH, DP_SEQ = 8, 128
DP_LOSS_TOL = (1e-3, 2e-2)  # train_full's steps 0 and 1, relative
PSUM_SHAPE, PSUM_SHARDS = (151_936, 2_560), 4   # qwen3-4b's embed gradient


def _dp_step(model, init, batch, mesh, lr):
    """One train step of ``model`` from the weights ``init`` over
    ``mesh`` (None: one device): (metrics as floats, the gradients the
    update took, the updated parameters), tensors on the card."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    model.load_state_dict(init)
    seen = []
    step = make_train_step(model, opt.OptConfig(lr=lr), mesh=mesh,
                           placement="replicated",
                           grad_transform=lambda g: seen.append(g) or g)
    m = step(opt.init(dict(model.named_parameters())), batch)
    metrics = {k: float(m[k]) for k in ("loss", "aux", "grad_norm", "lr")}
    return metrics, seen[0], {k: p.detach().clone()
                              for k, p in model.named_parameters()}


def _against_one_device(tag, one, other, step_lr):
    """``train_dp_parity``'s tolerances, one step of another layout
    (metrics, whole gradients, whole updated parameters) against the
    one-device step's; returns the case's numbers."""
    (m1, g1, p1), (m2, g2, p2) = one, other
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    check(rel(m2["loss"], m1["loss"]) <= 1e-3,
          f"{tag}: loss {m2['loss']} vs {m1['loss']}")
    check(rel(m2["aux"], m1["aux"]) <= 1e-3,
          f"{tag}: aux {m2['aux']} vs {m1['aux']}")
    check(rel(m2["grad_norm"], m1["grad_norm"]) <= GRAD_TOL,
          f"{tag}: grad norm {m2['grad_norm']} vs {m1['grad_norm']}")
    worst_g, worst_leaf, worst_p, loose = 0.0, None, 0.0, 0
    for k, want in g1.items():
        w = want.float()
        scale = float(w.abs().max())
        e = float((g2[k].float() - w).abs().max())
        check(e <= GRAD_TOL * scale, f"{tag} grad {k}: {e} > "
                                     f"{GRAD_TOL}·{scale}")
        if e / max(scale, 1e-30) > worst_g:
            worst_g, worst_leaf = e / max(scale, 1e-30), k
        tight = w.abs() > GRAD_TOL * scale
        a, b = p2[k].float(), p1[k].float()
        err = (a - b).abs()
        lim = 1e-6 + 2 ** -7 * torch.maximum(a.abs(), b.abs())
        check(bool((err[tight] <= lim[tight]).all()),
              f"{tag} {k}: updated parameters off by "
              f"{float(err[tight].max())}")
        check(bool((err[~tight] <= 2 * step_lr + lim[~tight]).all()),
              f"{tag} {k}: loose elements off by more than 2·lr")
        loose += int((~tight).sum())
        if bool(tight.any()):
            worst_p = max(worst_p, float((err[tight] / lim[tight]).max()))
    return {"loss": m2["loss"], "aux": m2["aux"],
            "grad_norm": m2["grad_norm"],
            "loss_rel_err": rel(m2["loss"], m1["loss"]),
            "aux_rel_err": rel(m2["aux"], m1["aux"]),
            "grad_norm_rel_err": rel(m2["grad_norm"], m1["grad_norm"]),
            "max_rel_grad_err": worst_g, "worst_leaf": worst_leaf,
            "param_tight_worst_share_of_tol": worst_p,
            "param_loose_elements": loose}


def phase_train_dp_parity(card: str) -> None:
    """The data-parallel step over ``make_host_mesh(data=2)`` and
    ``(data=4)`` — batch shards on the card, one replica — against the
    one-device step from the same weights and batch, for qwen3-4b and
    qwen3-moe-30b-a3b at their published widths cut to 2 layers, bf16,
    8 × 128 tokens.  Tolerances, those of ``train_parity`` (the shards'
    GEMMs have other shapes than the whole batch's, so their bf16
    outputs round differently, and the shards' bf16 gradients are
    summed in bf16): loss and aux loss within 1e-3
    relative, the grad norm within 2⁻⁵ relative, every leaf's gradient
    within 2⁻⁵·max|g| of the leaf; the updated bf16 parameters under the
    Adam rule at bf16 width: Adam's first step moves an element by about
    lr·sign(g), so an element whose gradient exceeds the gradient
    tolerance (2⁻⁵·max|g| of its leaf) moves the same way in both and
    lands within one bf16 ulp (2⁻⁷ of the larger value, + atol 1e-6);
    the others may move the other way, within 2·lr + that."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    rng = np.random.default_rng(17)
    lr = 1e-3
    for arch in DP_ARCHS:
        cfg = get_config(arch).replace(num_layers=2)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (DP_BATCH, DP_SEQ)
                                        ).astype(np.int32)}
        t0 = time.perf_counter()
        model = LM(cfg, device="cuda", seed=3)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        n = sum(p.numel() for p in init.values())
        m1, g1, p1 = _dp_step(model, init, batch, None, lr)
        step_lr = m1["lr"]
        cases = {}
        for shards in DP_SHARDS:
            torch.cuda.reset_peak_memory_stats()
            m2, g2, p2 = _dp_step(model, init, batch,
                                  make_host_mesh(data=shards), lr)
            peak = torch.cuda.max_memory_allocated()
            cases[f"data={shards}"] = _against_one_device(
                f"{arch} data={shards}", (m1, g1, p1), (m2, g2, p2),
                step_lr)
            cases[f"data={shards}"]["peak_memory_allocated"] = peak
            del g2, p2
            torch.cuda.empty_cache()
        emit(phase="train_dp_parity", card=card, arch=arch,
             case=f"{arch} 2 layers, bf16, full width", params=n,
             tokens=[DP_BATCH, DP_SEQ], lr=step_lr,
             one_device={"loss": m1["loss"], "aux": m1["aux"],
                         "grad_norm": m1["grad_norm"]},
             shards=cases,
             tol=f"loss and aux 1e-3 relative, grad norm {GRAD_TOL} "
                 f"relative, {GRAD_TOL}·max|g| a leaf; parameters where "
                 f"|g| > {GRAD_TOL}·max|g|: one bf16 ulp (2^-7 of the "
                 "larger) + 1e-6, the others 2·lr more",
             why="the shards' GEMMs round their bf16 outputs differently "
                 "from the whole batch's, and each shard's bf16 gradient "
                 "are summed in bf16",
             seconds=time.perf_counter() - t0)
        del model, init, g1, p1
        torch.cuda.empty_cache()


def _timed(fn, spans):
    """``fn`` with each call's device span (CUDA events) kept in
    ``spans``."""
    def wrapper(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args, **kwargs)
        ev[1].record()
        spans.append(ev)
        return out
    return wrapper


def train_dp_full_child(card: str, results=None) -> None:
    """``launch.train.run`` on qwen3-4b at full width and depth with
    ``--placement replicated`` over a ``make_host_mesh(data=2)`` mesh
    (two batch shards on the card, one replica, whose ``.grad`` sums
    both shards' gradients in the backward: no all-reduce runs on one
    card), the launcher's defaults otherwise (bf16, remat, 8 × 128), 10
    steps, in its own process.  Then, past the timed steps: one more
    step with the update timed by CUDA events (its calls summed), and
    one under the profiler."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = launch_train.parse_args(
        ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--log-every", "1", "--placement", "replicated"])
    mesh = make_host_mesh(data=2)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run = launch_train.run(args, mesh=mesh)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = run.history
    losses = [h["loss"] for h in hist]
    gnorms = [float(h["metrics"]["grad_norm"]) for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite train metrics: {losses} {gnorms}")
    step_ms = float(np.median([h["ms"] for h in hist[TRAIN_WARM:]]))
    n = sum(p.numel() for p in run.model.parameters())
    flop = train_flops(run.cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = run.pipe.batch_at(TRAIN_STEPS)
    spans = {"update": []}
    update = opt.update
    opt.update = _timed(update, spans["update"])
    run.step_fn(run.opt_state, batch)
    torch.cuda.synchronize()
    opt.update = update
    span_ms = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in spans.items()}
    prof = {}
    wall_ms, busy, top = device_profile(
        lambda: run.step_fn(run.opt_state, batch), prof)
    out = {"mesh": dict(run.mesh.shape),
           "devices": sorted({str(d) for d in run.mesh.devices.flat}),
           "slots": len(run.step_fn.slots), "params": n,
           "loss": losses, "grad_norm": gnorms,
           "step_ms": [h["ms"] for h in hist], "step_ms_p50": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflops": flop / step_ms / 1e9,
           "mfu": flop / (step_ms / 1e3) / PEAK_BF16,
           "peak_memory_allocated": peak, "run_s": wall_s,
           "update_ms": span_ms["update"],
           "profiled_step_wall_ms": wall_ms, "profiled_step_busy_ms": busy,
           "profiled_step_idle_share": None if busy is None
           else 1 - busy / wall_ms,
           "kernels_per_step": prof["device_kernels"],
           "launch_calls": {k: v["count"] for k, v in prof.items()
                            if k != "device_kernels"}, "top": top,
           "log": log.getvalue().splitlines()}
    if results is not None:
        results.put(out)


def phase_train_dp_full(card: str) -> None:
    """``train_dp_full_child`` in a spawned process, beside
    ``train_full``'s one-device numbers from this run (``train_full``
    runs first if it has not): step ms p50, tokens/s, ``mfu`` against
    989 TFLOP/s, peak memory (must fit 80 GB); the first two steps'
    losses equal ``train_full``'s within 1e-3 (step 0: the same weights
    and batch, bf16 rounding) and 2e-2 (step 1: Adam's first update is
    about lr·sign(g), and elements whose gradient is at bf16 rounding
    noise may move the other way) relative."""
    if "train_full" not in TRAIN_RESULTS:
        phase_train_full(card)
    one = TRAIN_RESULTS["train_full"]
    dp = run_child(train_dp_full_child, card, "train_dp_full_child")
    errs = [abs(a - b) / abs(b) for a, b in zip(dp["loss"][:2],
                                                one["loss"][:2])]
    for i, (e, tol) in enumerate(zip(errs, DP_LOSS_TOL)):
        check(e <= tol, f"train_dp_full step {i}: loss {dp['loss'][i]} vs "
                        f"train_full's {one['loss'][i]} (> {tol} relative)")
    check(dp["peak_memory_allocated"] < 80e9,
          f"peak memory {dp['peak_memory_allocated']} does not fit 80 GB")
    emit(phase="train_dp_full", card=card, arch=LM_ARCH,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
         step_ms_steps=f"{TRAIN_WARM + 1}-{TRAIN_STEPS}",
         loss_rel_err_steps_0_1=errs,
         loss_tol=f"{DP_LOSS_TOL[0]} (step 0), {DP_LOSS_TOL[1]} (step 1) "
                  "relative",
         **dp, one_device={k: one[k] for k in (
             "step_ms_p50", "tokens_per_s", "mfu", "peak_memory_allocated",
             "loss")})


def phase_psum(card: str) -> None:
    """``compressed_psum`` over 4 logical shards of a 151,936 × 2,560
    fp32 gradient on the card: bit-equal to the same call on the CPU,
    within the reference test's 8·scale of the exact (fp64) sum; its ms
    (CUDA events, warm) beside a plain fp32 sum's and ``all_reduce_mean``'s,
    and the byte bound of a sum (each shard read once, the result
    written once)."""
    from repro_torch.distributed.collectives import (all_reduce_mean,
                                                     compressed_psum)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    xs = [torch.randn(PSUM_SHAPE, generator=gen, device="cuda")
          * (1e-3 * (s + 1)) for s in range(PSUM_SHARDS)]
    got = compressed_psum(xs)
    check(len(got) == PSUM_SHARDS and all(g is got[0] for g in got),
          "compressed_psum: one shared result a device")
    got = got[0]
    exact = sum(x.double() for x in xs)
    scale = max(float(x.abs().max()) for x in xs) / 127.0
    err = float((got.double() - exact).abs().max())
    del exact
    check(err <= 8 * scale + 1e-5,
          f"compressed_psum: {err} from the exact sum (> 8·{scale})")
    host = compressed_psum([x.cpu() for x in xs])[0]
    bit_equal = torch.equal(got.cpu().view(torch.int32),
                            host.view(torch.int32))
    check(bit_equal, "compressed_psum on the card differs from the CPU's")
    del host
    ms = cuda_ms(lambda: compressed_psum(xs), reps=5)
    plain_ms = cuda_ms(lambda: xs[0] + xs[1] + xs[2] + xs[3], reps=5)
    mean_ms = cuda_ms(lambda: all_reduce_mean(xs), reps=5)
    nbytes = (PSUM_SHARDS + 1) * xs[0].numel() * 4
    emit(phase="psum", card=card, shape=list(PSUM_SHAPE),
         shards=PSUM_SHARDS, devices=sorted({str(x.device) for x in xs}),
         bit_equal_to_cpu=bit_equal, max_abs_err=err, scale=scale,
         tol="8·scale (the reference test's bound)", ms=ms,
         plain_sum_ms=plain_ms, all_reduce_mean_ms=mean_ms,
         bytes_bound_ms=nbytes / PEAK_BYTES * 1e3)
    del xs, got
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# FSDP placement — parameters and moments cut over the data axis — and
# the dry run's memory reckoning beside the measured peaks
# --------------------------------------------------------------------- #

def _fsdp_step(cfg, init, batch, mesh, lr):
    """One FSDP step of a fresh model loaded with ``init`` over ``mesh``:
    (metrics as floats, the whole gradients the update took, the whole
    updated parameters, what each slot holds between steps)."""
    from repro_torch.distributed import fsdp
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    model = LM(cfg, device="cuda", seed=3)
    model.load_state_dict(init)
    grads = {}

    def keep(g):
        # slot 0 holds a shard of every cut leaf and every replicated one
        if not grads:
            grads.update({k: fsdp.whole(t) for k, t in g.items()})
        return g

    step = make_train_step(model, opt.OptConfig(lr=lr), mesh=mesh,
                           placement="fsdp", grad_transform=keep)
    ostate = opt.init(dict(model.named_parameters()))
    m = step(ostate, batch)
    metrics = {k: float(m[k]) for k in ("loss", "aux", "grad_norm", "lr")}
    params = {k: fsdp.whole(p).detach().clone()
              for k, p in model.named_parameters()}
    n = mesh.size
    held = {"sharded_leaves": 0, "sharded_bytes": 0, "replicated_bytes": 0}
    for s, module in enumerate(step.slots):
        for k, p in module.named_parameters():
            g = fsdp.group(p)
            whole = params[k].shape
            if g is None:
                check(p.shape == whole, f"slot {s} {k}: {tuple(p.shape)}")
                if s == 0:
                    held["replicated_bytes"] += p.numel() * p.element_size()
                continue
            # no cut leaf held whole between steps: weights and moments
            cut = list(whole)
            cut[g.dim] //= n
            check(list(p.shape) == cut and g.shards[s] is p,
                  f"slot {s} {k}: {tuple(p.shape)}, not the shard {cut}")
            for part in ("m", "v"):
                mg = fsdp.group(ostate[part][k])
                check(mg is not None and all(
                    list(t.shape) == cut for t in mg.shards),
                    f"{k}: the {part} moments are not cut")
            if s == 0:
                held["sharded_leaves"] += 1
            held["sharded_bytes"] += p.numel() * p.element_size()
    del step, model, ostate
    return metrics, grads, params, held


def phase_train_fsdp_parity(card: str) -> None:
    """The FSDP step over ``make_host_mesh(data=2)`` and ``(data=4)`` —
    every slot's shards on the card — against the one-device step from
    the same weights and batch, ``train_dp_parity``'s shape and
    tolerances (qwen3-4b and qwen3-moe-30b-a3b at their published widths
    cut to 2 layers, bf16, 8 × 128 tokens: loss and aux loss within 1e-3
    relative, the grad norm within 2⁻⁵ relative, every leaf's gradient
    within 2⁻⁵·max|g|, the updated parameters under the Adam rule at
    bf16 width); and no cut leaf, weight or moment, held whole by any
    slot between steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    rng = np.random.default_rng(17)
    lr = 1e-3
    for arch in DP_ARCHS:
        cfg = get_config(arch).replace(num_layers=2)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (DP_BATCH, DP_SEQ)
                                        ).astype(np.int32)}
        t0 = time.perf_counter()
        model = LM(cfg, device="cuda", seed=3)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        n = sum(p.numel() for p in init.values())
        m1, g1, p1 = _dp_step(model, init, batch, None, lr)
        del model
        cases = {}
        for shards in DP_SHARDS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m2, g2, p2, held = _fsdp_step(cfg, init, batch,
                                          make_host_mesh(data=shards), lr)
            peak = torch.cuda.max_memory_allocated()
            case = _against_one_device(f"{arch} fsdp data={shards}",
                                       (m1, g1, p1), (m2, g2, p2), m1["lr"])
            case.update(held, peak_memory_allocated=peak)
            cases[f"data={shards}"] = case
            del g2, p2
        emit(phase="train_fsdp_parity", card=card, arch=arch,
             case=f"{arch} 2 layers, bf16, full width", params=n,
             tokens=[DP_BATCH, DP_SEQ], lr=m1["lr"],
             one_device={"loss": m1["loss"], "aux": m1["aux"],
                         "grad_norm": m1["grad_norm"]},
             shards=cases,
             tol=f"train_dp_parity's: loss and aux 1e-3 relative, grad "
                 f"norm {GRAD_TOL} relative, {GRAD_TOL}·max|g| a leaf; "
                 "parameters one bf16 ulp + 1e-6, loose ones 2·lr more",
             seconds=time.perf_counter() - t0)
        del init, g1, p1
        torch.cuda.empty_cache()


def train_fsdp_full_child(card: str, results=None) -> None:
    """``launch.train.run`` on qwen3-4b at full width and depth with
    ``--placement fsdp`` over ``make_host_mesh(data=2)`` (two slots on
    the card, each holding half of every cut leaf and of its moments),
    the launcher's defaults otherwise (bf16, remat, 8 × 128), 10 steps,
    in its own process.  Then one more step with the layer gathers, the
    gradient reduce-scatters (the gathers' backward) and the update
    timed by CUDA events (their calls summed), and one under the
    profiler."""
    import contextlib
    import io
    from repro_torch.distributed import fsdp
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = launch_train.parse_args(
        ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--log-every", "1", "--placement", "fsdp"])
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run = launch_train.run(args, mesh=make_host_mesh(data=2))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = run.history
    losses = [h["loss"] for h in hist]
    gnorms = [float(h["metrics"]["grad_norm"]) for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite train metrics: {losses} {gnorms}")
    step_ms = float(np.median([h["ms"] for h in hist[TRAIN_WARM:]]))
    n = sum(fsdp.whole(p, "meta").numel() for p in run.model.parameters())
    flop = train_flops(run.cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = run.pipe.batch_at(TRAIN_STEPS)
    spans = {"gather": [], "reduce_scatter": [], "update": []}
    fwd, bwd, update = fsdp._Gather.forward, fsdp._Gather.backward, \
        opt.update
    fsdp._Gather.forward = staticmethod(_timed(fwd, spans["gather"]))
    fsdp._Gather.backward = staticmethod(_timed(bwd,
                                                spans["reduce_scatter"]))
    opt.update = _timed(update, spans["update"])
    run.step_fn(run.opt_state, batch)
    torch.cuda.synchronize()
    fsdp._Gather.forward, fsdp._Gather.backward = (staticmethod(fwd),
                                                   staticmethod(bwd))
    opt.update = update
    span_ms = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in spans.items()}
    prof = {}
    wall_ms, busy, top = device_profile(
        lambda: run.step_fn(run.opt_state, batch), prof)
    cut = [p for p in run.model.parameters() if fsdp.group(p) is not None]
    out = {"mesh": dict(run.mesh.shape),
           "devices": sorted({str(d) for d in run.mesh.devices.flat}),
           "slots": len(run.step_fn.slots), "params": n,
           "cut_leaves": len(cut),
           "cut_share": sum(fsdp.whole(p, "meta").numel() for p in cut) / n,
           "loss": losses, "grad_norm": gnorms,
           "step_ms": [h["ms"] for h in hist], "step_ms_p50": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflops": flop / step_ms / 1e9,
           "mfu": flop / (step_ms / 1e3) / PEAK_BF16,
           "peak_memory_allocated": peak, "run_s": wall_s,
           "gather_ms": span_ms["gather"],
           "gather_calls": len(spans["gather"]),
           "reduce_scatter_ms": span_ms["reduce_scatter"],
           "reduce_scatter_calls": len(spans["reduce_scatter"]),
           "update_ms": span_ms["update"],
           "update_calls": len(spans["update"]),
           "profiled_step_wall_ms": wall_ms, "profiled_step_busy_ms": busy,
           "profiled_step_idle_share": None if busy is None
           else 1 - busy / wall_ms,
           "kernels_per_step": prof["device_kernels"],
           "launch_calls": {k: v["count"] for k, v in prof.items()
                            if k != "device_kernels"}, "top": top,
           "log": log.getvalue().splitlines()}
    if results is not None:
        results.put(out)


def phase_train_fsdp_full(card: str) -> None:
    """``train_fsdp_full_child`` in a spawned process, beside
    ``train_full``'s numbers from this run (``train_full`` runs first if
    it has not): step ms p50, tokens/s,
    ``mfu``, the gathers' and reduce-scatters' ms, kernels a step, peak
    memory (must fit 80 GB); the first two steps' losses equal
    ``train_full``'s within ``train_dp_full``'s tolerances."""
    if "train_full" not in TRAIN_RESULTS:
        phase_train_full(card)
    one = TRAIN_RESULTS["train_full"]
    cut = run_child(train_fsdp_full_child, card, "train_fsdp_full_child")
    TRAIN_RESULTS["train_fsdp_full"] = cut
    errs = [abs(a - b) / abs(b) for a, b in zip(cut["loss"][:2],
                                                one["loss"][:2])]
    for i, (e, tol) in enumerate(zip(errs, DP_LOSS_TOL)):
        check(e <= tol, f"train_fsdp_full step {i}: loss {cut['loss'][i]} "
                        f"vs train_full's {one['loss'][i]} (> {tol})")
    check(cut["peak_memory_allocated"] < 80e9,
          f"peak memory {cut['peak_memory_allocated']} does not fit 80 GB")
    emit(phase="train_fsdp_full", card=card, arch=LM_ARCH,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
         step_ms_steps=f"{TRAIN_WARM + 1}-{TRAIN_STEPS}",
         loss_rel_err_steps_0_1=errs,
         loss_tol=f"{DP_LOSS_TOL[0]} (step 0), {DP_LOSS_TOL[1]} (step 1) "
                  "relative",
         **cut, one_device={k: one[k] for k in (
             "step_ms_p50", "tokens_per_s", "mfu", "peak_memory_allocated",
             "loss")})


def phase_dryrun_fit(card: str) -> None:
    """The dry run (``launch.dryrun``: the port's step on fake tensors
    under ``MemTracker``, no allocation) on ``train_full``'s cell
    (qwen3-4b, 8 × 128, one card, remat, fp32 moments) and on
    ``train_fsdp_full``'s (the same over two slots on the card), its
    reckoned peak beside the peak ``torch.cuda.max_memory_allocated``
    measured in those phases of this run (they run first if they have
    not), and its state bytes beside theirs."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shapes import ShapeSpec
    if "train_full" not in TRAIN_RESULTS:
        phase_train_full(card)
    if "train_fsdp_full" not in TRAIN_RESULTS:
        phase_train_fsdp_full(card)
    shape = ShapeSpec("train_full", "train", TRAIN_SEQ, TRAIN_BATCH)
    cells = {}
    for tag, mesh in (("train_full", "1x1"), ("train_fsdp_full", Mesh(
            np.full((2, 1), torch.device("cuda", 0), dtype=object),
            ("data", "model")))):
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(LM_ARCH, shape, mesh, device="cuda")
        fake = rec["peak_bytes"]["cuda:0"]
        measured = TRAIN_RESULTS[tag]["peak_memory_allocated"]
        cells[tag] = {"mesh": rec["mesh"], "fake_peak_bytes": fake,
                      "measured_peak_bytes": measured,
                      "fake_over_measured": fake / measured,
                      "state_bytes": rec["state_bytes"],
                      "collective_bytes": rec["collectives"]["total_bytes"],
                      "roofline_s": rec["roofline_s"],
                      "seconds": time.perf_counter() - t0}
    emit(phase="dryrun_fit", card=card, arch=LM_ARCH,
         tokens=[TRAIN_BATCH, TRAIN_SEQ], cells=cells,
         how="launch.dryrun.lower_cell on fake cuda tensors (FakeTensorMode "
             "+ MemTracker), no card memory used; measured: "
             "torch.cuda.max_memory_allocated of the phase's process")


# one slot's reckoning of the dry run (``launch.dryrun.slot_peaks``): the
# pods' decode cells, each slot's program on fake cuda:0 tensors (its other
# slots on ``meta``; no card memory used); and train_fsdp_full's cell (a
# (2, 1) train step) on fake CPU tensors, beside the whole program of the
# same slot (its peer on ``meta``): a train cell without a model axis
# cannot run on fake cuda tensors with meta peers under torch 2.11 (an
# in-kernel assertion of the fake tensors at the first backward copy).
# They run in a pool of ``DRYRUN_WORKERS`` spawned processes from the end
# of the ``sharded`` phase (beside graphs, the FSDP phases and the LM
# index's serving, which share the host with the LM index child already)
# and ``dryrun_pods`` collects them before the DP, TP and serving-mesh
# phases, whose host-bound step times the pool would slow: at the end of
# the run instead, they took the script past its time limit.  A pod's
# train_4k slot takes many minutes of one host core: those cells come
# from ``scripts/dryrun_table.py --mesh pod,multipod``
DRYRUN_POD_CELLS = (("decode_32k", "pod"), ("decode_32k", "multipod"))
DRYRUN_WORKERS = 3
_DRYRUN_POOL = {}


def dryrun_jobs():
    """(tag, arch, shape, mesh name, slot, device, whole), the longest
    first: slots 0 and n−1 of each pod cell on fake cuda:0, and both
    slots of train_fsdp_full's cell on fake CPU tensors, reckoned and
    whole."""
    sizes = {"pod": 256, "multipod": 512}
    return [(f"{shape} {mesh}", LM_ARCH, shape, mesh, s, "cuda:0", False)
            for shape, mesh in DRYRUN_POD_CELLS[::-1]
            for s in (0, sizes[mesh] - 1)] + [
        ("train_fsdp_full", LM_ARCH, "train_fsdp_full", "2x1", s, "cpu",
         whole) for s in (0, 1) for whole in (False, True)]


def dryrun_job(job):
    """One slot's peak for one job of ``dryrun_jobs`` (in a worker):
    reckoned (``slot_peaks``), or ``whole``, the whole program of that
    slot with its other slots on ``meta``."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    tag, arch, shape, mesh, s, device, whole = job
    t0 = time.perf_counter()
    spec = SHAPES[shape] if shape in SHAPES else ShapeSpec(
        shape, "train", TRAIN_SEQ, TRAIN_BATCH)
    base = dryrun.make_mesh(mesh, device)
    rec = dryrun.lower_cell(arch, spec, base, peak=False)
    kw = dict(accum=rec["accum_steps"], moment_dtype=rec["moment_dtype"],
              accum_dtype=rec["accum_dtype"])
    if whole:
        peak = dryrun.measure_peak(get_config(arch), spec, dryrun.slot_mesh(
            base, s, device), **kw)[str(torch.device(device))]
    else:
        peak = dryrun.slot_peaks(get_config(arch), spec, base,
                                 torch.device(device), slots=[s],
                                 **kw)[f"slot {s}"]
    return tag, s, whole, peak, time.perf_counter() - t0


def start_dryrun_pool() -> None:
    """Start ``dryrun_jobs`` in a pool of ``DRYRUN_WORKERS`` spawned
    processes (once), a job at a time to each."""
    import multiprocessing
    if _DRYRUN_POOL:
        return
    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS)
    _DRYRUN_POOL.update(pool=pool, t0=time.perf_counter(),
                        result=pool.map_async(dryrun_job, dryrun_jobs(),
                                              chunksize=1))


def phase_dryrun_pods(card: str) -> None:
    """The dry run's one-slot reckonings (``dryrun_jobs``; the pool
    started here when no earlier phase started it): qwen3-4b's ``pod`` and ``multipod`` cells for ``decode_32k`` —
    slots 0 and n−1 reckoned, the per-card peak the larger, its fit, the
    state bytes, the collective term and roofline (``lower_cell(...,
    peak=False)``), each slot's seconds; then train_fsdp_full's cell on
    fake CPU tensors, each slot's reckoning equal to its whole program's
    peak, beside the peak ``train_fsdp_full`` measured on the card when
    it ran."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES
    start_dryrun_pool()
    pool, t0 = _DRYRUN_POOL["pool"], _DRYRUN_POOL["t0"]
    try:
        done = _DRYRUN_POOL["result"].get(timeout=1500)
    finally:
        pool.close()
        pool.join()
        _DRYRUN_POOL.clear()
    cells, fsdp_cell = {}, {}
    for tag, s, whole, peak, secs in done:
        if tag == "train_fsdp_full":
            fsdp_cell.setdefault(f"slot {s}", {})[
                "whole" if whole else "one_slot"] = {"peak_bytes": peak,
                                                     "seconds": secs}
            continue
        cell = cells.setdefault(tag, {"slot_peaks": {}, "slot_seconds": {}})
        cell["slot_peaks"][f"slot {s}"] = peak
        cell["slot_seconds"][f"slot {s}"] = secs
    for shape, mesh in DRYRUN_POD_CELLS:
        cell = cells[f"{shape} {mesh}"]
        rec = dryrun.lower_cell(LM_ARCH, SHAPES[shape], mesh, peak=False)
        per = max(cell["slot_peaks"].values())
        cell.update(per_device_peak_bytes=per,
                    fits_80gb=bool(per < dryrun.HBM_CAPACITY),
                    state_bytes=rec["state_bytes"],
                    collectives=rec["collectives"],
                    roofline_s=rec["roofline_s"], dominant=rec["dominant"],
                    seconds=sum(cell["slot_seconds"].values()))
        check(rec["state_bytes"]["total"] <= per,
              f"{shape} {mesh}: a peak below its state")
    emit(phase="dryrun_pods", card=card, arch=LM_ARCH, cells=cells,
         how="launch.dryrun.slot_peaks: one slot's program on fake cuda:0 "
             "tensors, every other slot meta, no card memory used; "
             f"{DRYRUN_WORKERS} worker processes",
         seconds=time.perf_counter() - t0)
    for slot, got in fsdp_cell.items():
        check(got["one_slot"]["peak_bytes"] == got["whole"]["peak_bytes"],
              f"train_fsdp_full {slot}: the reckoning {got['one_slot']} "
              f"differs from the whole program {got['whole']}")
    measured = TRAIN_RESULTS.get("train_fsdp_full", {}).get(
        "peak_memory_allocated")
    emit(phase="dryrun_fsdp_one_slot", card=card, arch=LM_ARCH,
         tokens=[TRAIN_BATCH, TRAIN_SEQ], mesh="2x1", slots=fsdp_cell,
         measured_peak_bytes=measured,
         how="launch.dryrun.slot_peaks (one_slot) and measure_peak (whole, "
             "the other slot on meta) on fake CPU tensors (the CPU's GEMM "
             "path); measured: torch.cuda.max_memory_allocated of "
             "train_fsdp_full (both slots on the card), null when that "
             "phase did not run")


# --------------------------------------------------------------------- #
# tensor parallelism — heads, FFN, experts and vocabulary cut over the
# model axis of a (data, model) mesh
# --------------------------------------------------------------------- #

TP_MESHES = ((1, 2), (2, 2), (1, 4))   # (data, model), every slot on card 0
TP_STEPS = 3
FULL_LOSS_TOL = (1e-3, 2e-2, 5e-2)    # steps 0, 1, 2, relative
TP_FULL_MODEL = 2


def _spec_local_shapes(cfg, mesh, whole):
    """Each parameter's local shape on ``mesh`` as the spec tables say:
    its reference leaf's spec (``ShardingRules.param_specs`` over
    ``convert.reference_shapes``), the leading layer axes dropped, each
    cut axis divided by its mesh axis."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models.convert import ShapeLeaf, reference_shapes
    leaves = {k: ShapeLeaf(v) for k, v in whole.items()}
    specs = ShardingRules(cfg, mesh).param_specs(
        reference_shapes(cfg, leaves))
    out = {}
    for k, shape in whole.items():
        parts = k.split(".")
        spec = specs
        for part in [q for q in parts if not q.isdigit()]:
            spec = spec[part]
        tail = tuple(spec)[sum(q.isdigit() for q in parts):]
        out[k] = tuple(n // (1 if ax is None else mesh.shape[ax])
                       for n, ax in zip(shape, tail))
    return out


def _tp_run(cfg, init, batches, mesh, lr):
    """``len(batches)`` steps of a fresh model loaded with ``init``, over
    ``mesh`` (None: one device): (each step's metrics as floats, the
    number of slot leaves off the spec's local shape, the slots' count
    of leaves cut over the model axis)."""
    from repro_torch.distributed import fsdp
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    model = LM(cfg, device="cuda", seed=3)
    model.load_state_dict(init)
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    step = make_train_step(model, opt.OptConfig(lr=lr), mesh=mesh)
    ostate = opt.init(dict(model.named_parameters()))
    metrics = []
    for batch in batches:
        m = step(ostate, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                 "grad_norm")})
    off = tp_cut = 0
    if mesh is not None:
        want = _spec_local_shapes(cfg, mesh, whole)
        for s, module in enumerate(step.slots):
            for k, p in module.named_parameters():
                off += tuple(p.shape) != want[k]
                g = fsdp.group(p)
                tp_cut += g is not None and g.tp_dim is not None
    del step, model, ostate
    torch.cuda.empty_cache()
    return metrics, off, tp_cut


def phase_train_tp_parity(card: str) -> None:
    """The tensor-parallel step over ``make_host_mesh(data, model)`` for
    ``TP_MESHES`` (every slot on the card) against the one-device step
    from the same weights and batches: qwen3-4b and qwen3-moe-30b-a3b at
    their published widths cut to 2 layers, bf16, 8 × 128 tokens, 3
    steps; losses, MoE aux losses and grad norms within
    ``FULL_LOSS_TOL`` relative at steps 0, 1, 2; and every slot's every
    leaf of the local shape the spec tables give on its mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    rng = np.random.default_rng(19)
    lr = 1e-3
    for arch in DP_ARCHS:
        cfg = get_config(arch).replace(num_layers=2)
        batches = [{"tokens": rng.integers(0, cfg.vocab_size,
                                           (DP_BATCH, DP_SEQ)
                                           ).astype(np.int32)}
                   for _ in range(TP_STEPS)]
        t0 = time.perf_counter()
        model = LM(cfg, device="cuda", seed=3)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        del model
        one, _, _ = _tp_run(cfg, init, batches, None, lr)
        cases = {}
        for data, model_size in TP_MESHES:
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            got, off, tp_cut = _tp_run(
                cfg, init, batches,
                make_host_mesh(data=data, model=model_size,
                               device="cuda:0"), lr)
            tag = f"{arch} ({data}, {model_size})"
            check(off == 0, f"{tag}: {off} slot leaves off the spec's "
                            "local shapes")
            check(tp_cut > 0, f"{tag}: no leaf cut over the model axis")
            errs = {}
            for key in ("loss", "aux", "grad_norm"):
                errs[key] = [abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
                             for g, w in zip(got, one)]
                for i, (e, tol) in enumerate(zip(errs[key], FULL_LOSS_TOL)):
                    check(e <= tol, f"{tag} step {i}: {key} {got[i][key]} "
                                    f"vs {one[i][key]} (> {tol})")
            cases[f"{data}x{model_size}"] = {
                "loss": [g["loss"] for g in got],
                "aux": [g["aux"] for g in got],
                "grad_norm": [g["grad_norm"] for g in got],
                **{f"{k}_rel_err": v for k, v in errs.items()},
                "slot_leaves_off_spec": off, "tp_cut_slot_leaves": tp_cut,
                "peak_memory_allocated": torch.cuda.max_memory_allocated(),
                "seconds": time.perf_counter() - t1}
        emit(phase="train_tp_parity", card=card, arch=arch,
             case=f"{arch} 2 layers, bf16, full width", steps=TP_STEPS,
             tokens=[DP_BATCH, DP_SEQ], lr=lr,
             one_device={k: [m[k] for m in one]
                         for k in ("loss", "aux", "grad_norm")},
             meshes=cases,
             tol=f"loss, aux and grad norm {list(FULL_LOSS_TOL)} relative "
                 "at steps 0, 1, 2; every slot leaf the spec's local shape",
             seconds=time.perf_counter() - t0)
        del init
        torch.cuda.empty_cache()


def train_tp_full_child(card: str, results=None) -> None:
    """``launch.train.run`` on qwen3-4b at full width and depth over
    ``make_host_mesh(data=1, model=TP_FULL_MODEL)`` (the TP ranks on the
    card), the launcher's defaults otherwise (bf16, fp32 moments, remat,
    8 × 128), 10 steps, in its own process.  Then one more step with the
    TP collectives (``distributed.tp``'s autograd functions, forward
    and backward) and the update timed by CUDA events (their calls
    summed), and one under the profiler."""
    import contextlib
    import io
    from repro_torch.distributed import fsdp, tp
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = launch_train.parse_args(
        ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--log-every", "1"])
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run = launch_train.run(args, mesh=make_host_mesh(
            data=1, model=TP_FULL_MODEL, device="cuda:0"))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = run.history
    losses = [h["loss"] for h in hist]
    gnorms = [float(h["metrics"]["grad_norm"]) for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite train metrics: {losses} {gnorms}")
    step_ms = float(np.median([h["ms"] for h in hist[TRAIN_WARM:]]))
    n = sum(fsdp.whole(p, "meta").numel() for p in run.model.parameters())
    flop = train_flops(run.cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = run.pipe.batch_at(TRAIN_STEPS)
    spans = {"tp": [], "update": []}
    fns = [tp._Copy, tp._Reduce, tp._AllGather, tp._ReduceScatter,
           tp._GatherRow, tp._Split]
    saved = [(f, f.forward, f.backward) for f in fns]
    for f, fwd, bwd in saved:
        f.forward = staticmethod(_timed(fwd, spans["tp"]))
        f.backward = staticmethod(_timed(bwd, spans["tp"]))
    update = opt.update
    opt.update = _timed(update, spans["update"])
    run.step_fn(run.opt_state, batch)
    torch.cuda.synchronize()
    for f, fwd, bwd in saved:
        f.forward, f.backward = staticmethod(fwd), staticmethod(bwd)
    opt.update = update
    span_ms = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in spans.items()}
    prof = {}
    wall_ms, busy, top = device_profile(
        lambda: run.step_fn(run.opt_state, batch), prof)
    cut = [p for p in run.model.parameters()
           if fsdp.group(p) is not None and fsdp.group(p).tp_dim is not None]
    out = {"mesh": dict(run.mesh.shape),
           "devices": sorted({str(d) for d in run.mesh.devices.flat}),
           "slots": len(run.step_fn.slots), "params": n,
           "tp_cut_leaves": len(cut),
           "tp_cut_share": sum(fsdp.whole(p, "meta").numel()
                               for p in cut) / n,
           "loss": losses, "grad_norm": gnorms,
           "step_ms": [h["ms"] for h in hist], "step_ms_p50": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflops": flop / step_ms / 1e9,
           "mfu": flop / (step_ms / 1e3) / PEAK_BF16,
           "peak_memory_allocated": peak, "run_s": wall_s,
           "tp_collective_ms": span_ms["tp"],
           "tp_collective_calls": len(spans["tp"]),
           "update_ms": span_ms["update"],
           "update_calls": len(spans["update"]),
           "profiled_step_wall_ms": wall_ms, "profiled_step_busy_ms": busy,
           "profiled_step_idle_share": None if busy is None
           else 1 - busy / wall_ms,
           "kernels_per_step": prof["device_kernels"],
           "launch_calls": {k: v["count"] for k, v in prof.items()
                            if k != "device_kernels"}, "top": top,
           "log": log.getvalue().splitlines()}
    if results is not None:
        results.put(out)


def phase_train_tp_full(card: str) -> None:
    """``train_tp_full_child`` in a spawned process, beside
    ``train_full``'s numbers from this run (``train_full`` runs first if
    it has not): step ms p50, tokens/s, ``mfu``, the TP collectives' ms
    and calls, kernels a step, peak memory (must fit 80 GB); steps 0 and
    1's losses equal ``train_full``'s within ``FULL_LOSS_TOL``."""
    if "train_full" not in TRAIN_RESULTS:
        phase_train_full(card)
    one = TRAIN_RESULTS["train_full"]
    cut = run_child(train_tp_full_child, card, "train_tp_full_child")
    TRAIN_RESULTS["train_tp_full"] = cut
    errs = [abs(a - b) / abs(b) for a, b in zip(cut["loss"][:2],
                                                one["loss"][:2])]
    for i, (e, tol) in enumerate(zip(errs, FULL_LOSS_TOL)):
        check(e <= tol, f"train_tp_full step {i}: loss {cut['loss'][i]} "
                        f"vs train_full's {one['loss'][i]} (> {tol})")
    check(cut["peak_memory_allocated"] < 80e9,
          f"peak memory {cut['peak_memory_allocated']} does not fit 80 GB")
    emit(phase="train_tp_full", card=card, arch=LM_ARCH,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
         step_ms_steps=f"{TRAIN_WARM + 1}-{TRAIN_STEPS}",
         loss_rel_err_steps_0_1=errs,
         loss_tol=f"{FULL_LOSS_TOL[0]} (step 0), {FULL_LOSS_TOL[1]} "
                  "(step 1) relative",
         **cut, one_device={k: one[k] for k in (
             "step_ms_p50", "tokens_per_s", "mfu", "peak_memory_allocated",
             "loss")})


# --------------------------------------------------------------------- #
# serving under tensor parallelism — the KV cache's sequence cut over the
# model axis, heads, FFN, experts and vocabulary as in training
# --------------------------------------------------------------------- #

SERVE_TP_STEPS = 16
# the serving meshes on the card: PR 22's, and (2, 1), every weight cut
# over data alone (decode in the weight-stationary layout)
SERVE_TP_MESHES = TP_MESHES + ((2, 1),)
SERVE_FULL_MESHES = ((1, TP_FULL_MODEL), (2, 1))


def _collective_spans(fn):
    """{"tp": (calls, device ms), "data": (calls, device ms)} of the
    serving collectives in ``fn()``: every collective of ``tp``, timed by
    CUDA events, once (not again inside another); those that
    ``layers.over_data`` calls — the data axis's sums of a
    weight-stationary decode's fp32 partials and joins of its column
    slices — under ``data``, the others under ``tp``."""
    import sys as _sys
    from repro_torch.distributed import tp
    spans = {"tp": [], "data": []}
    fns = {f.__name__: f for f in (tp.max_over_ranks, tp.sum_over_ranks,
                                   tp.fold_to, tp.gather_to,
                                   tp.argmax_over_ranks)}
    classes = [tp._Copy, tp._Reduce, tp._AllGather, tp._ReduceScatter,
               tp._GatherRow, tp._Split]
    saved = [(c, c.forward) for c in classes]

    def timed(f):
        def wrapper(*args, **kwargs):
            caller = _sys._getframe(1)
            if caller.f_globals is vars(tp):    # inside a timed one
                return f(*args, **kwargs)
            axis = "data" if caller.f_code.co_name == "over_data" else "tp"
            return _timed(f, spans[axis])(*args, **kwargs)
        return wrapper
    for name, f in fns.items():
        setattr(tp, name, timed(f))
    for c, fwd in saved:
        c.forward = staticmethod(_timed(fwd, spans["tp"]))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, f in fns.items():
            setattr(tp, name, f)
        for c, fwd in saved:
            c.forward = staticmethod(fwd)
    return {axis: (len(v), sum(a.elapsed_time(b) for a, b in v))
            for axis, v in spans.items()}


def _cache_bytes(placed):
    """Each slot's cache bytes (its distinct pieces)."""
    out = []
    for tree in placed.slots:
        seen = {}
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                seen[id(node)] = node.numel() * node.element_size()
        out.append(sum(seen.values()))
    return out


def _cache_off_spec(model, mesh, placed, batch, max_len) -> int:
    """The slot cache leaves whose shape is not the local shape
    ``cache_specs`` gives on ``mesh``."""
    from repro_torch.distributed.sharding import ShardingRules
    struct = model.init_cache(batch, max_len, "meta")
    specs = ShardingRules(model.cfg, mesh).cache_specs(struct, batch)
    off = 0
    for tree in placed.slots:
        for key in struct:
            want = tuple(n // (1 if ax is None else _axes_size(mesh, ax))
                         for n, ax in zip(struct[key].shape, specs[key]))
            off += tuple(tree[key].shape) != want
    return off


def _axes_size(mesh, ax) -> int:
    n = 1
    for a in ((ax,) if isinstance(ax, str) else ax):
        n *= mesh.shape[a]
    return n


@contextlib.contextmanager
def _routes_logged(log):
    """Inside: every MoE routing appends (its probabilities, its expert
    ids) as host arrays to ``log``."""
    from repro_torch.models import moe as MOE
    route = MOE.route

    def logged(params, x, **kw):
        out = route(params, x, **kw)
        log.append((host(out[0]), host(out[2])))
        return out
    MOE.route = logged
    try:
        yield log
    finally:
        MOE.route = route


def _route_flips(one, got, batch: int, layers: int, rows: int,
                 tol: float):
    """Where the mesh's routing chose other experts than one device's:
    ``one`` holds one device's routings (a step, a layer), ``got`` the
    mesh's (prefill: a data row of ``rows``, a layer; each decode step,
    which routes every sequence at once in the weight-stationary layout:
    a layer).  Each differing choice must be a near tie of one device's
    router: its k-th and (k+1)-th probabilities within ``tol`` of each
    other, relative.  Returns (a (step, sequence) mask of the logits
    whose own token — the prompt's last at step 0, the fed token after —
    was routed to other experts in some layer; the flips' relative
    gaps)."""
    steps = len(one) // layers
    own = np.zeros((steps, batch), dtype=bool)
    gaps = []
    for n, (probs, ids) in enumerate(one):
        step, layer = divmod(n, layers)
        at = [r * layers + layer for r in range(rows)] if step == 0 else \
            [(rows + step - 1) * layers + layer]
        mesh_ids = np.concatenate([got[i][1] for i in at])
        differ = (np.sort(ids, -1) != np.sort(mesh_ids, -1)).any(-1)
        k = ids.shape[-1]
        for b, t in zip(*np.nonzero(differ)):
            top = np.sort(probs[b, t])[::-1]
            gap = float((top[k - 1] - top[k]) / top[k - 1])
            check(gap <= tol, f"routing at step {step}, layer {layer}, "
                              f"sequence {b}: a flip over a gap of {gap}")
            gaps.append(gap)
            own[step, b] |= t == ids.shape[1] - 1
    return own, gaps


def phase_serve_tp_parity(card: str) -> None:
    """Prefill and greedy decode over ``make_host_mesh(data, model)`` for
    ``TP_MESHES`` (every slot on the card) against the one-device calls
    on the same weights: qwen3-4b and qwen3-moe-30b-a3b at their
    published widths cut to 2 layers, bf16, 8 prompts of 128 tokens and
    ``SERVE_TP_STEPS`` steps fed the one-device tokens.  The last logits
    within ``LM_TOL``·max|logit| at every step, the tokens equal but at
    near ties; every slot's weights and cache pieces of the spec tables'
    local shapes.  A MoE routing that differs from one device's must be
    a near tie of the router (``_route_flips``); a step's logits of a
    sequence whose own token was so routed are not held (its experts
    differ; at most a quarter of them), and the record counts them.
    Decode runs in the weight-stationary layout: its FSDP gathers
    (``fsdp.COUNTS``) must read 0 at every step; one more step times the
    data axis's collectives (``SERVE_TP_MESHES`` adds ``(2, 1)``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.serve.step import make_decode, make_prefill
    rng = np.random.default_rng(23)
    max_len = LM_PROMPT_LEN + SERVE_TP_STEPS
    for arch in DP_ARCHS:
        cfg = get_config(arch).replace(num_layers=2)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN))).cuda()
        t0 = time.perf_counter()
        model = LM(cfg, device="cuda", seed=3)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        whole = {k: tuple(p.shape) for k, p in init.items()}
        with _routes_logged([]) as one_routes:
            cache, lg = model.prefill(prompts, max_len)
            one, feed = [host(lg)], []
            for i in range(SERVE_TP_STEPS):
                feed.append(torch.from_numpy(one[-1].argmax(-1)).cuda())
                lg, cache = model.decode_step(cache, feed[-1][:, None],
                                              LM_PROMPT_LEN + i)
                one.append(host(lg))
        del model, cache
        cases = {}
        for data, model_size in SERVE_TP_MESHES:
            mesh = make_host_mesh(data=data, model=model_size,
                                  device="cuda:0")
            tag = f"{arch} ({data}, {model_size})"
            t1 = time.perf_counter()
            model = LM(cfg, device="cuda", seed=3)
            model.load_state_dict(init)
            prefill = make_prefill(model, max_len, mesh=mesh)
            decode = make_decode(model, mesh=mesh)
            gathers = []
            with _routes_logged([]) as routes:
                placed, nxt = prefill(prompts)
                got, toks = [host(prefill.last_logits())], [host(nxt)]
                for i in range(SERVE_TP_STEPS):
                    fsdp.COUNTS["gathers"] = 0
                    nxt, placed = decode(placed, feed[i][:, None],
                                         LM_PROMPT_LEN + i)
                    gathers.append(fsdp.COUNTS["gathers"])
                    got.append(host(decode.last_logits()))
                    toks.append(host(nxt[:, 0]))
            check(not any(gathers), f"{tag}: decode gathered {gathers} "
                                    "weights a step")
            calls, coll_ms = _collective_spans(lambda: decode(
                placed, feed[-1][:, None], max_len - 1))["data"]
            flipped, gaps = _route_flips(one_routes, routes, LM_PROMPTS,
                                         cfg.num_layers, data, LM_TOL)
            if not one_routes:
                flipped = np.zeros((len(one), LM_PROMPTS), dtype=bool)
            errs, ties = [], 0
            for i, (g, w, tk) in enumerate(zip(got, one, toks)):
                held = ~flipped[i]
                tol = LM_TOL * float(np.abs(w).max())
                e = float(np.abs(g - w)[held].max(initial=0.0))
                check(e <= tol, f"{tag} step {i}: logits differ by {e} > "
                                f"{tol}")
                errs.append(e / float(np.abs(w).max()))
                ties += len(_near_tie_tokens(tk[held], w[held], tol))
            want = _spec_local_shapes(cfg, mesh, whole)
            off = sum(tuple(p.shape) != want[k] for m in prefill.slots
                      for k, p in m.named_parameters())
            off_cache = _cache_off_spec(model, mesh, placed, LM_PROMPTS,
                                        max_len)
            check(off == 0 and off_cache == 0,
                  f"{tag}: {off} weight and {off_cache} cache leaves off "
                  "the spec's local shapes")
            check(flipped.mean() <= 0.25,
                  f"{tag}: {int(flipped.sum())} of {flipped.size} step "
                  "logits of a token routed to other experts")
            cases[f"{data}x{model_size}"] = {
                "max_rel_err": max(errs), "rel_err_steps": errs,
                "near_ties": ties, "route_flips": len(gaps),
                "route_flip_gap_max": max(gaps, default=None),
                "logits_unheld": int(flipped.sum()),
                "logits_held": int((~flipped).sum()),
                "slot_cache_bytes": _cache_bytes(placed),
                "decode_gathers_max": max(gathers),
                "data_collective_calls_step": calls,
                "data_collective_ms_step": coll_ms,
                "seconds": time.perf_counter() - t1}
            del model, prefill, decode, placed
            torch.cuda.empty_cache()
        emit(phase="serve_tp_parity", card=card, arch=arch,
             case=f"{arch} 2 layers, bf16, full width",
             prompts=[LM_PROMPTS, LM_PROMPT_LEN], steps=SERVE_TP_STEPS,
             max_len=max_len, meshes=cases,
             tol="logits within LM_TOL·max|logit| at every step, tokens "
                 "equal but at near ties, but where the token's own MoE "
                 "routing flipped at a near tie of the router (LM_TOL "
                 "relative; at most a quarter); every slot's weights and "
                 "cache pieces the spec's local shapes",
             seconds=time.perf_counter() - t0)
        del init
        torch.cuda.empty_cache()


def phase_serve_tp_full(card: str) -> None:
    """qwen3-4b at full width and depth (the LM phases' model, re-made
    from its seed), bf16: ``lm_generate``'s prompts and steps on one
    device (timed again here, beside the numbers of ``lm_generate``),
    then the same model placed over each of ``SERVE_FULL_MESHES`` on the
    card (``(1, TP_FULL_MODEL)``, and ``(2, 1)``: decode in the
    weight-stationary layout, every weight cut over data alone; a fresh
    model a mesh): prefill ms, decode ms a step (p50, p25/p75), fed
    ``lm_generate``'s tokens, whose greedy tokens must equal them but at
    near ties (``LM_TOL``·max|logit| of the mesh's logits); one more step
    with the serving collectives and the data axis's timed by CUDA events
    (no weight gathered); kernels a decode step (profiler) on one device
    and on the mesh; the peak and each slot's cache bytes.  One line a
    mesh."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp, tp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.serve.step import make_decode, make_prefill
    cfg = get_config(LM_ARCH)
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN))).cuda()
    max_len = LM_PROMPT_LEN + LM_STEPS
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda", seed=0)

    def generate(prefill, decode, feed=None):
        prefill(prompts)                          # warm-up at this shape
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache, nxt = prefill(prompts)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t1) * 1e3
        gen, ms, logits = [nxt[:, None]], [], []
        for i in range(LM_STEPS):
            tok = gen[-1] if feed is None else feed[:, i:i + 1]
            t1 = time.perf_counter()
            nxt, cache = decode(cache, tok, LM_PROMPT_LEN + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            gen.append(nxt)
            if feed is not None:
                logits.append(host(decode.last_logits()))
        return cache, torch.cat(gen, 1), pre_ms, ms, logits

    def profiled(prefill, decode):
        cache, nxt = prefill(prompts)
        nxt, cache = decode(cache, nxt[:, None], LM_PROMPT_LEN)  # warm-up
        prof = {}
        wall, busy, top = device_profile(
            lambda: decode(cache, nxt, LM_PROMPT_LEN + 1), prof)
        return {"wall_ms": wall, "busy_ms": busy,
                "kernels": prof["device_kernels"], "top": top[:4]}

    _, gen_one, pre_one, ms_one, _ = generate(make_prefill(model, max_len),
                                              make_decode(model))
    feed = torch.from_numpy(LM_GENERATED["gen"]).cuda() \
        if "gen" in LM_GENERATED else gen_one
    one = {"prefill_ms": pre_one,
           "decode_ms_p50": float(np.median(ms_one)),
           "decode_ms_p25_p75": np.percentile(ms_one, [25, 75]).tolist(),
           "tokens_equal_lm_generate": bool(torch.equal(gen_one, feed)),
           "lm_generate": {k: (float(np.median(v)) if k == "step_ms" else v)
                           for k, v in LM_GENERATED.items() if k != "gen"},
           **profiled(make_prefill(model, LM_PROMPT_LEN + 2),
                      make_decode(model))}
    for n, (data, model_size) in enumerate(SERVE_FULL_MESHES):
        if n:       # a model is placed on one mesh: the next gets its own
            model = LM(cfg, device="cuda", seed=0)
        mesh = make_host_mesh(data=data, model=model_size, device="cuda:0")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        prefill = make_prefill(model, max_len, mesh=mesh)
        decode = make_decode(model, mesh=mesh)
        fsdp.COUNTS["gathers"] = 0
        placed, gen, pre_ms, ms, logits = generate(prefill, decode, feed)
        peak = torch.cuda.max_memory_allocated()
        ties = []
        for i, lg in enumerate(logits):
            ties += _near_tie_tokens(host(feed[:, i + 1]), lg,
                                     LM_TOL * float(np.abs(lg).max()))
        fsdp.COUNTS["gathers"] = 0
        spans = _collective_spans(lambda: decode(placed, feed[:, -1:],
                                                 max_len - 1))
        decode_gathers = fsdp.COUNTS["gathers"]
        check(decode_gathers == 0, f"decode over {dict(mesh.shape)} "
                                   f"gathered {decode_gathers} weights")
        del placed
        torch.cuda.empty_cache()
        prof = profiled(make_prefill(model, LM_PROMPT_LEN + 2, mesh=mesh),
                        decode)
        placed, _ = prefill(prompts)
        slot_bytes = _cache_bytes(placed)
        check(peak < 80e9, f"peak memory {peak} does not fit 80 GB")
        emit(phase="serve_tp_full", card=card, arch=LM_ARCH,
             mesh=dict(mesh.shape), prompts=[LM_PROMPTS, LM_PROMPT_LEN],
             steps=LM_STEPS, max_len=max_len, prefill_ms=pre_ms,
             decode_ms_p50=float(np.median(ms)),
             decode_ms_p25_p75=np.percentile(ms, [25, 75]).tolist(),
             decode_ms=ms, tp_collective_ms=spans["tp"][1],
             tp_collective_calls=spans["tp"][0],
             data_collective_ms=spans["data"][1],
             data_collective_calls=spans["data"][0],
             decode_gathers=decode_gathers, near_tie_gaps=ties,
             near_tie_tol=f"{LM_TOL}·max|logit| of the mesh's logits",
             peak_memory_allocated=peak, slot_cache_bytes=slot_bytes,
             cache_bytes_whole=2 * cfg.num_layers * LM_PROMPTS * max_len
             * cfg.num_kv_heads * cfg.head_dim * 2,
             profiled_decode=prof, one_device=one,
             seconds=time.perf_counter() - t0)
        del model, prefill, decode, placed
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    emit(phase="card", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    t_start = time.perf_counter()
    phase_build()
    if PHASES is not None:
        if "edges" in PHASES:
            phase_edges()
        if "beam" in PHASES:
            phase_beam()
        if "graphs" in PHASES:
            phase_graphs()
        for name, phase in {**TRAIN_PHASES, **DP_PHASES, **FSDP_PHASES,
                            **TP_PHASES, **SERVE_TP_PHASES,
                            **POD_PHASES}.items():
            if name in PHASES:
                phase(card)
        emit(phase="done", partial=sorted(PHASES),
             seconds=time.perf_counter() - t_start)
        return 0
    phase_edges()
    model = phase_lm_model(card)
    phase_lm_parity(card)
    lm_run = phase_lm_embed(model, card)
    try:
        phase_lm_generate(model, card)
        del model
        torch.cuda.empty_cache()
        for phase in TRAIN_PHASES.values():
            phase(card)
        kernels = run_index_phases(card, lm_run)
        # the pool's results, before the phases whose host-bound step
        # times it would slow
        phase_dryrun_pods(card)
        for phase in (*DP_PHASES.values(), *TP_PHASES.values(),
                      *SERVE_TP_PHASES.values()):
            phase(card)
    finally:
        lm_run.stop()
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_index_phases(card, lm_run):
    """The main path, unfiltered, beam, serving, sharded and graphs
    phases, the last of them while the LM index builds in its child
    process, then the LM requests on that index; the ``kernels`` line's
    entries (``beam_f32``'s launches are the graphs phase's)."""
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
    kernels.append(phase_beam(table))
    del table
    torch.cuda.empty_cache()
    phase_serving(*serving_inputs)
    launches, shapes = phase_sharded(*serving_inputs)
    # the LM index builds on the host from here on, past the index phases
    # whose host-bound times this script reports (the child takes a core),
    # and so do the dry run's one-slot reckonings (``dryrun_jobs``)
    lm_run.start()
    start_dryrun_pool()
    for line in kernels:
        line["launches_sharded"] = launches.get(line["name"], 0)
        if line["name"] in shapes:
            line["sharded_shape"] = shapes[line["name"]]
    del serving_inputs
    torch.cuda.empty_cache()
    launches, wave = phase_graphs()              # beam_f32's path
    kernels[-1].update(launches=launches, code_wave=wave)
    torch.cuda.empty_cache()
    # while the LM index builds in its child (one host core): the FSDP
    # phases report no parent-process host time but their own child's
    for phase in FSDP_PHASES.values():
        phase(card)
    launches, shapes = phase_lm_serve(card, lm_run)
    phase_lm_profile(card)
    for line in kernels:
        line["launches_lm"] = launches.get(line["name"], 0)
        if line["name"] in shapes:
            line["lm_shape"] = shapes[line["name"]]
    return kernels


PHASES = None           # None: every phase; else a subset (see --phases)
TRAIN_PHASES = {"train_parity": phase_train_parity,
                "train_full": phase_train_full,
                "train_embedder": phase_train_embedder}
DP_PHASES = {"train_dp_parity": phase_train_dp_parity,
             "train_dp_full": phase_train_dp_full,
             "psum": phase_psum}
FSDP_PHASES = {"train_fsdp_parity": phase_train_fsdp_parity,
               "train_fsdp_full": phase_train_fsdp_full,
               "dryrun_fit": phase_dryrun_fit}
POD_PHASES = {"dryrun_pods": phase_dryrun_pods}
TP_PHASES = {"train_tp_parity": phase_train_tp_parity,
             "train_tp_full": phase_train_tp_full}
SERVE_TP_PHASES = {"serve_tp_parity": phase_serve_tp_parity,
                   "serve_tp_full": phase_serve_tp_full}

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        PHASES = set(sys.argv[2].split(","))
        check(PHASES <= {"build", "edges", "beam", "graphs", *TRAIN_PHASES,
                         *DP_PHASES,
                         *FSDP_PHASES, *TP_PHASES, *SERVE_TP_PHASES,
                         *POD_PHASES},
              f"--phases takes build, edges, beam, graphs, "
              f"{sorted(TRAIN_PHASES)}, "
              f"{sorted(DP_PHASES)}, {sorted(FSDP_PHASES)}, "
              f"{sorted(TP_PHASES)}, {sorted(SERVE_TP_PHASES)} and "
              f"{sorted(POD_PHASES)}, not {sorted(PHASES)}")
    elif len(sys.argv) != 1:
        sys.exit("usage: chip_smoke.py [--phases build,edges,beam,graphs,"
                 + ",".join([*TRAIN_PHASES, *DP_PHASES, *FSDP_PHASES,
                             *TP_PHASES, *SERVE_TP_PHASES, *POD_PHASES])
                 + "]")
    sys.exit(main())

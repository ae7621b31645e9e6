"""Exact fp32 top-k: segmented over descriptor-resolved candidates, and
unsegmented over a whole base.

Port of ``src/repro/kernels/distance_topk.py``.  Candidate sets arrive
as ``(seg_start, seg_len, owner)`` descriptor triples into the
device-resident CSR ``base_ids`` plus explicit tails;
``expand_descriptors`` and ``assemble_flat_candidates`` resolve them on
the device into one flat candidate layout, and ``topk_seg_f32`` ranks
every query row against the flat columns of its own owner.
``distance_topk`` ranks every query row against every row of the base.

``topk_seg_f32`` is the wrapper of kernel A (``csrc/topk_seg.cu``, the
port of the Pallas ``_topk_seg_kernel``), ``distance_topk`` of
``topk_f32`` (``csrc/topk_dense.cu``, the port of ``_topk_kernel``):
on a CUDA tensor each launches the hand-written kernel, on a CPU tensor
it runs its plain PyTorch version (``segmented_dense_topk``,
``dense_topk``).  Both honour the same contract: (Q, k) ascending
distances and column indices, lower column first on equal distance,
``(+inf, -1)`` where fewer than k columns match.

Kernel A, like kernel B (``quant.qtopk_seg_sq8``), skips (row tile,
column tile) pairs whose owners cannot meet: rows are taken in the order
of a stable argsort of ``qseg``, and a pair is computed only if the
two-sign owner ranges of its row tile and column tile meet
(``tile_owner_ranges``, ``tiles_meet``: the plain versions of the
kernels' pre-pass and of their per-tile test).  ``tile_stats`` reads
how many pairs each kernel's launches since ``reset_tile_stats``
computed.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import pairwise_negdot_ref, pairwise_sqdist_ref
from .tuning import (select_dense_splits, select_dense_tile,
                     select_f32_splits, select_f32_tiles)

_INF = float("inf")
_I32_MAX, _I32_MIN = 2 ** 31 - 1, -2 ** 31
_METRICS = ("l2", "ip")
_ACCUMS = ("f32", "bf16")


def dense_distance(x: torch.Tensor, y: torch.Tensor, *, metric: str = "l2",
                   accum: str = "f32") -> torch.Tensor:
    """The dense (Q, N) GEMM-form distance matrix of ``_dist_tile``:
    ``accum="bf16"`` rounds the operands to bf16 and keeps the products,
    sums and norms in fp32.  The plain version of the pairwise kernel, and
    the distances of every plain top-k here."""
    if accum == "bf16":
        x, y = x.float().bfloat16(), y.float().bfloat16()
    if metric == "l2":
        return pairwise_sqdist_ref(x, y)
    return pairwise_negdot_ref(x, y)


def segmented_dense_topk(x: torch.Tensor, y: torch.Tensor,
                         qseg: torch.Tensor, owners: torch.Tensor, k: int, *,
                         metric: str = "l2", accum: str = "f32"):
    """Plain PyTorch segmented top-k: one dense (Q, N) distance matrix,
    owner mask, stable sort.  The plain version of kernel A, and the
    counterpart of the reference's ``segmented_dense_topk``.

    ``x`` (Q, d), ``y`` (N, d), ``qseg`` (Q,) owner per query row,
    ``owners`` (N,) owner per candidate.  Returns (Q, k) ascending
    distances and positions into ``y``; unfilled slots are (+inf, -1)."""
    return masked_topk(dense_distance(x, y, metric=metric, accum=accum),
                       qseg, owners, k)


def dense_topk(x: torch.Tensor, y: torch.Tensor, k: int, *,
               metric: str = "l2", accum: str = "f32"):
    """Plain PyTorch unsegmented top-k, the plain version of
    ``topk_f32``: the distances of ``segmented_dense_topk`` without the
    owner mask, then the same stable top-k."""
    return stable_topk(dense_distance(x, y, metric=metric, accum=accum), k)


def masked_topk(dist: torch.Tensor, qseg: torch.Tensor, owners: torch.Tensor,
                k: int):
    """The segmented top-k of a dense (Q, N) distance matrix: pairs whose
    owners differ become +inf, then ``stable_topk``."""
    match = qseg.reshape(-1, 1) == owners.reshape(1, -1)
    return stable_topk(torch.where(match, dist, _INF), k)


def stable_topk(dist: torch.Tensor, k: int):
    """The first k of a stable sort of each row of ``dist`` (lower column
    first on equal distance, as ``lax.top_k``).  Returns (Q, k) values
    and int32 columns, (+inf, -1) wherever the value is not finite or the
    row has fewer than k columns."""
    q, n = dist.shape
    kk = min(k, n)
    pos = torch.argsort(dist, dim=1, stable=True)[:, :kk]
    vals = dist.gather(1, pos)
    bad = ~torch.isfinite(vals)
    vals = torch.where(bad, _INF, vals)
    idx = torch.where(bad, -1, pos).to(torch.int32)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((q, k - kk), _INF)], 1)
        idx = torch.cat([idx, idx.new_full((q, k - kk), -1)], 1)
    return vals, idx


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_inputs(device: torch.device, specs) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` in ``specs``
    lies on ``device`` with that dtype and shape, contiguous."""
    for name, t, dtype, shape in specs:
        _require(t.device == device, f"{name} on {t.device}, expected "
                 f"{device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(tuple(t.shape) == shape,
                 f"{name} shape {tuple(t.shape)}, expected {shape}")
        _require(t.is_contiguous(), f"{name} must be contiguous")


def scan_buffers(q: int, kp: int, bq: int, s: int, device: torch.device):
    """Fresh buffers of one split-N top-k launch with row tiles of ``bq``
    and ``s`` N-splits: ``(flags ((Q/bq)·S) int32, partial (Q·S·kp)
    int64 scratch, vals (Q, kp) fp32, idx (Q, kp) int32)``."""
    return (torch.empty(-(-q // bq) * s, dtype=torch.int32, device=device),
            torch.empty(q * s * kp, dtype=torch.int64, device=device),
            torch.empty((q, kp), dtype=torch.float32, device=device),
            torch.empty((q, kp), dtype=torch.int32, device=device))


def f32_scan_buffers(q: int, n: int, kp: int, device: torch.device):
    """Tiles, N-splits and fresh buffers of one kernel A launch:
    ``(bq, bn, S, *scan_buffers)``."""
    bq, bn = select_f32_tiles(q, segmented=True)
    s = select_f32_splits(q, n, bq, bn, k=kp, segmented=True)
    return (bq, bn, s, *scan_buffers(q, kp, bq, s, device))


def dense_plan(q: int, n: int, d: int, kp: int):
    """``(bq, bn, resident, S)`` of one ``topk_f32`` launch: its tile,
    whether x stays in shared memory, and its N-splits."""
    bq, bn, resident = select_dense_tile(q, d, kp)
    s = select_dense_splits(q, n, bq, bn, k=kp, d=d, resident=resident)
    return bq, bn, resident, s


def vec_loads_ok(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the fp32 kernels may load both operands as 16-byte
    vectors: d a multiple of 4 and both bases 16-byte aligned.  Otherwise
    the wrapper launches the scalar-load instantiation of the same
    kernel."""
    return (x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
            and y.data_ptr() % 16 == 0)


# --------------------------------------------------------------------- #
# the owner skip of kernels A and B: the plain versions of their pre-pass
# and tile test, and their counters of computed tile pairs
# --------------------------------------------------------------------- #

def tile_owner_ranges(owners: torch.Tensor, block: int) -> torch.Tensor:
    """Per tile of ``block`` consecutive entries of ``owners`` (the last
    tile ragged): ``(min, max)`` over owners ≥ 0, then over owners < 0,
    as a (tiles, 4) int32 tensor; an empty range is (INT32_MAX,
    INT32_MIN).  The plain version of the ``tile_owner_ranges``
    pre-pass of kernels A and B (column tiles, and row tiles of the
    owner-sorted rows)."""
    n = int(owners.shape[0])
    t = max(1, -(-n // block))
    o = torch.full((t * block,), 0, dtype=torch.int64, device=owners.device)
    valid = torch.zeros(t * block, dtype=torch.bool, device=owners.device)
    o[:n] = owners.long()
    valid[:n] = True
    o, valid = o.reshape(t, block), valid.reshape(t, block)
    pos, neg = valid & (o >= 0), valid & (o < 0)
    return torch.stack([torch.where(pos, o, _I32_MAX).amin(1),
                        torch.where(pos, o, _I32_MIN).amax(1),
                        torch.where(neg, o, _I32_MAX).amin(1),
                        torch.where(neg, o, _I32_MIN).amax(1)],
                       1).to(torch.int32)


def tiles_meet(row_ranges: torch.Tensor,
               col_ranges: torch.Tensor) -> torch.Tensor:
    """(R, T) bool: whether row tile r and column tile t can hold a pair
    of equal owners, from their two-sign ranges (``tile_owner_ranges``):
    equal owners share a sign, so the pair is kept exactly when the
    ranges of one sign meet."""
    a = row_ranges.long()[:, None, :]
    b = col_ranges.long()[None, :, :]
    pos = torch.maximum(a[..., 0], b[..., 0]) <= torch.minimum(a[..., 1],
                                                               b[..., 1])
    neg = torch.maximum(a[..., 2], b[..., 2]) <= torch.minimum(a[..., 3],
                                                               b[..., 3])
    return pos | neg


_tile_counters: dict = {}       # (kernel, device) -> (1,) int64 computed
_tiles_launched: dict = {}      # kernel -> tile pairs in the grids launched


def reset_tile_stats() -> None:
    """Zero the counts of computed and launched tile pairs of kernels A
    (``topk_seg_f32``) and B (``qtopk_seg_sq8``)."""
    for c in _tile_counters.values():
        c.zero_()
    _tiles_launched.clear()


def tile_stats(kernel: str = "topk_seg_f32") -> dict:
    """(row tile, column tile) pairs of ``kernel`` since the last
    ``reset_tile_stats``: ``computed`` (counted by the kernel on the
    device; reading it synchronises) and ``total`` (in the grids
    launched)."""
    return {"computed": int(sum(int(c.item())
                                for (name, _), c in _tile_counters.items()
                                if name == kernel)),
            "total": _tiles_launched.get(kernel, 0)}


def tile_counter(kernel: str, device: torch.device,
                 launched: int) -> torch.Tensor:
    """The device counter a segmented launch of ``kernel`` adds its
    computed tile pairs to; records the ``launched`` pairs of its grid."""
    _tiles_launched[kernel] = _tiles_launched.get(kernel, 0) + launched
    c = _tile_counters.get((kernel, device))
    if c is None:
        c = _tile_counters[(kernel, device)] = torch.zeros(
            1, dtype=torch.int64, device=device)
    return c


def owner_sort(qseg: torch.Tensor, q_tiles: int, n_tiles: int):
    """The row order of a segmented launch (stable argsort of ``qseg``,
    int32) and its range scratch: ``n_tiles`` column tiles then
    ``q_tiles`` row tiles of int4."""
    perm = torch.argsort(qseg, stable=True).to(torch.int32)
    ranges = torch.empty((n_tiles + q_tiles, 4), dtype=torch.int32,
                         device=qseg.device)
    return perm, ranges


def _check_topk_args(metric: str, accum: str, kp: int) -> None:
    _require(metric in _METRICS, f"unknown metric {metric!r}")
    _require(accum in _ACCUMS, f"unknown accum {accum!r}")
    _require(1 <= kp <= 128, f"kp={kp} outside the kernel's 1..128")


def topk_seg_f32(x: torch.Tensor, y: torch.Tensor, qseg: torch.Tensor,
                 cseg: torch.Tensor, kp: int, *, metric: str = "l2",
                 accum: str = "f32"):
    """Kernel A: segmented exact fp32 top-kp of ``x`` (Q, d) against the
    flat candidate rows ``y`` (N, d); query row r ranks only columns c
    with ``cseg[c] == qseg[r]``.  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/topk_seg.cu`` (``launches`` counts those
    launches) or raise — there is no fallback."""
    _check_topk_args(metric, accum, kp)
    if x.device.type == "cpu":
        return segmented_dense_topk(x, y, qseg, cseg, kp, metric=metric,
                                    accum=accum)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    q, d = x.shape
    n = y.shape[0]
    check_inputs(x.device, (("x", x, torch.float32, (q, d)),
                            ("y", y, torch.float32, (n, d)),
                            ("qseg", qseg, torch.int32, (q,)),
                            ("cseg", cseg, torch.int32, (n,))))
    _require(q > 0 and n > 0 and d > 0, f"empty scan ({q}, {n}, {d})")
    bq, bn, s, flags, partial, vals, idx = f32_scan_buffers(q, n, kp,
                                                            x.device)
    n_tiles, q_tiles = -(-n // bn), -(-q // bq)
    perm, ranges = owner_sort(qseg, q_tiles, n_tiles)
    counter = tile_counter("topk_seg_f32", x.device, q_tiles * n_tiles)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("topk_seg_f32", lib.topk_seg_f32(
        x.data_ptr(), y.data_ptr(), qseg.data_ptr(), cseg.data_ptr(),
        perm.data_ptr(), ranges.data_ptr(), flags.data_ptr(),
        counter.data_ptr(), q, n, d, kp,
        int(metric == "ip"), int(accum == "bf16"), int(vec_loads_ok(x, y)),
        bq, bn, s, partial.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        stream))
    topk_seg_f32.launches += 1
    return vals, idx


topk_seg_f32.launches = 0


def distance_topk(x: torch.Tensor, y: torch.Tensor, kp: int, *,
                  metric: str = "l2", accum: str = "f32"):
    """``topk_f32``: exact fp32 top-kp of ``x`` (Q, d) against every row
    of ``y`` (N, d).  Ragged Q and N are masked in the kernel, so nothing
    is padded or copied; columns ≥ N never enter the result, and rows
    with fewer than kp columns end in (+inf, -1).  CPU tensors take the
    plain version ``dense_topk``; CUDA tensors launch
    ``csrc/topk_dense.cu`` (``launches`` counts those launches) or
    raise."""
    _check_topk_args(metric, accum, kp)
    if x.device.type == "cpu":
        return dense_topk(x, y, kp, metric=metric, accum=accum)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    q, d = x.shape
    n = y.shape[0]
    check_inputs(x.device, (("x", x, torch.float32, (q, d)),
                            ("y", y, torch.float32, (n, d))))
    _require(q > 0 and n > 0 and d > 0, f"empty scan ({q}, {n}, {d})")
    bq, bn, resident, s = dense_plan(q, n, d, kp)
    flags, partial, vals, idx = scan_buffers(q, kp, bq, s, x.device)
    # the rows' shared bounds, then the publication flags (set in the C
    # entry), and the lists the blocks publish once
    bound = torch.empty(q + flags.shape[0], dtype=torch.int32,
                        device=x.device)
    pub = torch.empty_like(partial)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("topk_f32", lib.topk_f32(
        x.data_ptr(), y.data_ptr(), flags.data_ptr(), bound.data_ptr(),
        pub.data_ptr(), q, n, d, kp, int(metric == "ip"),
        int(accum == "bf16"), int(vec_loads_ok(x, y)), bq, bn,
        int(resident), s, partial.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), stream))
    distance_topk.launches += 1
    return vals, idx


distance_topk.launches = 0


# --------------------------------------------------------------------- #
# descriptor mode: candidates resolved against the device-resident CSR
# --------------------------------------------------------------------- #

def expand_descriptors(base_ids: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, owners: torch.Tensor,
                       n_desc: int):
    """Expand ``(seg_start, seg_len, owner)`` triples into a flat
    candidate-id + owner pair of length ``n_desc``, on the device of the
    inputs.  Descriptor d occupies flat slots [Σ lens[:d], Σ lens[:d+1]);
    slot i of it resolves to ``base_ids[starts[d] + i]`` with owner
    ``owners[d]``.  Slots past Σ lens get the unmatchable owner -3 and
    candidate position 0."""
    dev = starts.device
    cum = torch.cumsum(lens.long(), 0)
    slot = torch.arange(n_desc, dtype=torch.int64, device=dev)
    d = torch.searchsorted(cum, slot, right=True)
    dc = d.clamp(max=lens.shape[0] - 1)
    within = slot - (cum[dc] - lens.long()[dc])
    valid = slot < cum[-1]
    pos = torch.where(valid, starts.long()[dc] + within, 0)
    nb = int(base_ids.shape[0])
    if nb:
        cand = base_ids[pos.clamp(0, nb - 1)].to(torch.int32)
    else:               # JAX reads of an empty table fill with zeros
        cand = torch.zeros(n_desc, dtype=torch.int32, device=dev)
    own = torch.where(valid, owners.long()[dc], -3).to(torch.int32)
    return cand, own


def resident_candidates(base_ids, deleted, starts, lens, owners,
                        tail_res_ids, tail_res_owners, n_desc: int):
    """The resident half of the flat layout: descriptor expansion then the
    resident tail, as ``(global ids, owners)`` int32, with tombstoned
    candidates reassigned to the unmatchable owner -3."""
    dev = tail_res_ids.device
    if n_desc:
        dcand, down = expand_descriptors(base_ids, starts, lens, owners,
                                         n_desc)
    else:
        dcand = torch.empty(0, dtype=torch.int32, device=dev)
        down = torch.empty(0, dtype=torch.int32, device=dev)
    cand = torch.cat([dcand, tail_res_ids.to(torch.int32)])
    own = torch.cat([down, tail_res_owners.to(torch.int32)])
    dn = int(deleted.shape[0])
    if dn and cand.shape[0]:
        dead = deleted[cand.long().clamp(0, dn - 1)]
        own = torch.where(dead, -3, own).to(torch.int32)
    return cand, own


def assemble_flat_candidates(vectors, base_ids, deleted, starts, lens,
                             owners, tail_res_ids, tail_res_owners,
                             tail_ship_ids, tail_ship_owners,
                             tail_ship_rows, n_desc: int):
    """Flat candidate layout shared by the fp32 and SQ8 paths:

      [ descriptor region (n_desc) | resident tail | shipped tail ]

    Returns ``(y (N, d) rows, cseg (N,) int32 owners, gid_flat (N,)
    int32 global ids)``; tombstoned resident candidates get the
    unmatchable owner -3."""
    cand_res, own_res = resident_candidates(
        base_ids, deleted, starts, lens, owners, tail_res_ids,
        tail_res_owners, n_desc)
    parts = []
    if cand_res.shape[0]:
        parts.append(vectors[cand_res.long()])
    if tail_ship_rows.shape[0]:
        parts.append(tail_ship_rows)
    y = torch.cat(parts, 0) if len(parts) > 1 else parts[0]
    cseg = torch.cat([own_res, tail_ship_owners.to(torch.int32)])
    gid_flat = torch.cat([cand_res, tail_ship_ids.to(torch.int32)])
    return y.contiguous(), cseg.contiguous(), gid_flat


def distance_topk_descriptors(vectors, base_ids, deleted, x, qseg, starts,
                              lens, owners, tail_res_ids, tail_res_owners,
                              tail_ship_ids, tail_ship_owners,
                              tail_ship_rows, k: int, *, n_desc: int,
                              metric: str = "l2", accum: str = "f32"):
    """Segmented top-k whose candidate sets are descriptors into the
    device-resident CSR (see ``assemble_flat_candidates``); ranks with
    kernel A on CUDA and its plain version on the CPU.  ``qseg`` is the
    (Q,) owner per query row.  Returns ``(vals, gids)`` of shape (Q, k):
    ascending distances and GLOBAL candidate ids, (+inf, -1) padding."""
    y, cseg, gid_flat = assemble_flat_candidates(
        vectors, base_ids, deleted, starts, lens, owners, tail_res_ids,
        tail_res_owners, tail_ship_ids, tail_ship_owners, tail_ship_rows,
        n_desc)
    n = int(y.shape[0])
    vals, idx = topk_seg_f32(x.contiguous(), y, qseg.contiguous(), cseg, k,
                             metric=metric, accum=accum)
    gids = torch.where(idx >= 0, gid_flat[idx.long().clamp(0, n - 1)], -1)
    return vals, gids.to(torch.int32)


__all__ = ["topk_seg_f32", "distance_topk", "dense_distance",
           "segmented_dense_topk", "dense_topk", "masked_topk", "stable_topk",
           "scan_buffers", "f32_scan_buffers", "dense_plan", "vec_loads_ok",
           "tile_owner_ranges", "tiles_meet", "tile_stats",
           "reset_tile_stats", "tile_counter", "owner_sort", "check_inputs",
           "expand_descriptors",
           "resident_candidates", "assemble_flat_candidates",
           "distance_topk_descriptors"]

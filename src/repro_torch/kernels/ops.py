"""Executor-facing wrappers around the scan kernels.

Port of ``src/repro/kernels/ops.py`` (all but the XLA twins, whose part
the plain PyTorch versions play):

  * **shape buckets** (``bucket``) — every dynamic dimension pads to a
    power-of-two multiple of 128 rows, so the kernels see a bounded set
    of shapes and the launch counters stay comparable with the
    reference's;
  * **launch accounting** (``record_launch`` / ``launch_stats``) with the
    reference's kind names (``desc_scan``, ``sq8_scan``,
    ``graph_fused``, ``graph_fused_filt``, ``merge``) plus ``launches``,
    ``retraces`` (first sight of a (kind, shape-bucket) key) and
    ``executables`` (distinct keys);
  * the **descriptor launch** ``topk_segmented_desc`` (kernel A on CUDA,
    its plain version on the CPU);
  * the **unsegmented exact k-NN** entry points ``topk``
    (``distance_topk.distance_topk``) and ``pairwise_sqdist``
    (``pairwise.pairwise_distance``), and the host-materialised
    ``topk_segmented`` over kernel A.  They take tensors and run where
    the tensors are; ragged Q and N are masked in the kernels, so no
    operand is padded or copied;
  * the **device merge** ``merge_topk_device`` (plain PyTorch, as it was
    XLA code in the reference);
  * the NumPy host oracle ``topk_numpy`` / ``topk_segmented_numpy``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .distance_topk import (distance_topk, distance_topk_descriptors,
                            topk_seg_f32)
from .pairwise import pairwise_distance

_LANE = 128


# --------------------------------------------------------------------- #
# shape buckets + launch accounting
# --------------------------------------------------------------------- #

def bucket(n: int, floor: int = _LANE) -> int:
    """Smallest power-of-two multiple of ``floor`` holding ``n`` rows (0
    stays 0)."""
    if n <= 0:
        return 0
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


_launch_counters: Dict[str, int] = {}
_launch_keys: set = set()


def record_launch(kind: str, key: Tuple) -> None:
    """Count one launch of ``kind``; a (kind, key) pair not seen since the
    last reset counts as a retrace (a new shape bucket)."""
    _launch_counters[kind] = _launch_counters.get(kind, 0) + 1
    _launch_counters["launches"] = _launch_counters.get("launches", 0) + 1
    if (kind, key) not in _launch_keys:
        _launch_keys.add((kind, key))
        _launch_counters["retraces"] = (
            _launch_counters.get("retraces", 0) + 1)


def launch_stats() -> Dict[str, int]:
    """Launch/retrace counters since the last reset; ``executables`` is
    the number of distinct (kind, shape-bucket) keys seen."""
    out = dict(_launch_counters)
    out.setdefault("launches", 0)
    out.setdefault("retraces", 0)
    out["executables"] = len(_launch_keys)
    return out


def reset_launch_stats() -> None:
    _launch_counters.clear()
    _launch_keys.clear()


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _check_k(k: int) -> int:
    """The kernels' list width kp = round_up(k, 8); raises past 128."""
    kp = _round_up(k, 8)
    if kp > _LANE:
        raise ValueError(f"k={k} exceeds kernel max {_LANE}")
    return kp


# --------------------------------------------------------------------- #
# unsegmented exact k-NN and the host-materialised segmented API
# --------------------------------------------------------------------- #

def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor, *, metric: str = "l2",
                    accum: str = "f32") -> torch.Tensor:
    """(Q, d) × (N, d) -> (Q, N) distances via the pairwise kernel."""
    return pairwise_distance(x.float().contiguous(), y.float().contiguous(),
                             metric=metric, accum=accum)


def topk(x: torch.Tensor, y: torch.Tensor, k: int, *, metric: str = "l2",
         accum: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of every row of ``x`` against every row of ``y``:
    (Q, k) ascending distances and int32 row indices, lower index first
    on equal distance.  When k > N the trailing entries are (+inf, -1);
    no index ≥ N is returned.  k > 128 raises."""
    kp = _check_k(k)
    vals, idx = distance_topk(x.float().contiguous(), y.float().contiguous(),
                              kp, metric=metric, accum=accum)
    return vals[:, :k], idx[:, :k]


def topk_segmented(x: torch.Tensor, y: torch.Tensor, qseg, cseg, k: int, *,
                   metric: str = "l2", accum: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented exact top-k: ONE launch serving many (query, id-set)
    pairs.  ``qseg`` (Q,) assigns each query row an owner id, ``cseg``
    (N,) each candidate row; query r ranks only candidates c with
    ``cseg[c] == qseg[r]``.  Owner ids are ≥ 0; a row with qseg -1
    matches nothing.  Returns (Q, k) ascending distances and row indices
    into ``y``; unfilled slots (segment smaller than k, or empty) are
    (+inf, -1).  k > 128 raises."""
    kp = _check_k(k)
    qs = torch.as_tensor(qseg, dtype=torch.int32, device=x.device)
    cs = torch.as_tensor(cseg, dtype=torch.int32, device=x.device)
    vals, idx = topk_seg_f32(x.float().contiguous(), y.float().contiguous(),
                             qs.contiguous(), cs.contiguous(), kp,
                             metric=metric, accum=accum)
    return vals[:, :k], idx[:, :k]


# --------------------------------------------------------------------- #
# descriptor launch
# --------------------------------------------------------------------- #

def pad_descriptor_batch(x, qseg, desc_starts, desc_lens, desc_owners,
                         tail_res_ids, tail_res_owners, tail_ship_ids,
                         tail_ship_rows, tail_ship_owners, *,
                         device) -> Tuple[tuple, tuple]:
    """Bucket-pad the host-side inputs of a descriptor launch (shared by
    the fp32 and SQ8 paths) and move them to ``device``.  Returns the
    positional args ``(x, qseg (qp, 1), starts, lens, owners,
    tail_res_ids, tail_res_owners, tail_ship_ids, tail_ship_owners,
    tail_ship_rows)`` and the bucket key ``(qp, n_desc, tr, ts, dp, d)``.
    Padded query rows own -1, padded descriptors and tails -3.  ``x``
    may be an array or a tensor already on ``device`` (the executor's
    query rows, gathered there); it is padded on the device."""
    q, d = x.shape
    qp = bucket(q)
    xp = torch.zeros((qp, d), dtype=torch.float32, device=device)
    xp[:q] = torch.as_tensor(x, dtype=torch.float32, device=device)
    qsp = np.full((qp, 1), -1, np.int32)
    qsp[:q, 0] = qseg
    nd_real = int(desc_lens.sum()) if len(desc_lens) else 0
    n_desc = bucket(nd_real)
    dp = bucket(len(desc_starts), 8) if n_desc else 0

    def _pad1(a, n, fill):
        out = np.full(n, fill, np.int32)
        out[:len(a)] = a
        return out

    tr = bucket(len(tail_res_ids))
    ts = bucket(len(tail_ship_ids))
    if n_desc + tr + ts == 0:
        raise ValueError("descriptor launch with no candidates")
    rows = np.zeros((ts, d), np.float32)
    rows[:len(tail_ship_rows)] = tail_ship_rows
    host = (qsp, _pad1(desc_starts, dp, 0), _pad1(desc_lens, dp, 0),
            _pad1(desc_owners, dp, -3), _pad1(tail_res_ids, tr, 0),
            _pad1(tail_res_owners, tr, -3), _pad1(tail_ship_ids, ts, 0),
            _pad1(tail_ship_owners, ts, -3), rows)
    args = (xp,) + tuple(torch.from_numpy(a).to(device) for a in host)
    return args, (qp, n_desc, tr, ts, dp, d)


def topk_segmented_desc(vectors: torch.Tensor, base_ids: torch.Tensor,
                        deleted: torch.Tensor, x: np.ndarray,
                        qseg: np.ndarray, desc_starts: np.ndarray,
                        desc_lens: np.ndarray, desc_owners: np.ndarray,
                        tail_res_ids: np.ndarray,
                        tail_res_owners: np.ndarray,
                        tail_ship_ids: np.ndarray,
                        tail_ship_rows: np.ndarray,
                        tail_ship_owners: np.ndarray, k: int, *,
                        metric: str = "l2", accum: str = "f32"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descriptor-driven segmented top-k: ONE launch serving many
    (query, id-set) pairs whose frozen-base candidates are ``(seg_start,
    seg_len, owner)`` triples against the resident CSR.  Returns tensors
    ``(vals, gids)`` of shape (Q, k) on the table's device: ascending
    distances and global ids, (+inf, -1) padding."""
    q = x.shape[0]
    kp = _check_k(k)
    args, key = pad_descriptor_batch(
        x, qseg, desc_starts, desc_lens, desc_owners, tail_res_ids,
        tail_res_owners, tail_ship_ids, tail_ship_rows, tail_ship_owners,
        device=vectors.device)
    xp, qsp, *rest = args
    vals, gids = distance_topk_descriptors(
        vectors, base_ids, deleted, xp, qsp[:, 0], *rest, kp,
        n_desc=key[1], metric=metric, accum=accum)
    record_launch("desc_scan", key + (kp, metric))
    vals, gids = vals[:q, :k], gids[:q, :k]
    bad = (gids < 0) | ~torch.isfinite(vals)
    return torch.where(bad, float("inf"), vals), torch.where(bad, -1, gids)


# --------------------------------------------------------------------- #
# NumPy host oracle (bit-compatible with the reference's)
# --------------------------------------------------------------------- #

def topk_numpy(x: np.ndarray, y: np.ndarray, k: int, *, metric: str = "l2"
               ) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if metric == "l2":
        d = (np.sum(x * x, axis=1, keepdims=True) + np.sum(y * y, axis=1)
             - 2.0 * (x @ y.T))
        np.maximum(d, 0.0, out=d)
    else:
        d = -(x @ y.T)
    k_eff = min(k, y.shape[0])
    part = np.argpartition(d, k_eff - 1, axis=1)[:, :k_eff]
    pv = np.take_along_axis(d, part, axis=1)
    order = np.argsort(pv, axis=1, kind="stable")
    idx = np.take_along_axis(part, order, axis=1)
    vals = np.take_along_axis(pv, order, axis=1)
    if k_eff < k:
        pad = k - k_eff
        vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
        idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
    return vals, idx


def topk_segmented_numpy(x: np.ndarray, y: np.ndarray, qseg: np.ndarray,
                         cseg: np.ndarray, k: int, *, metric: str = "l2"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host reference for the segmented top-k (same output contract)."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    qseg = np.asarray(qseg, dtype=np.int64)
    cseg = np.asarray(cseg, dtype=np.int64)
    q = x.shape[0]
    vals = np.full((q, k), np.inf, dtype=np.float32)
    idx = np.full((q, k), -1, dtype=np.int32)
    for r in range(q):
        if qseg[r] < 0:
            continue
        cols = np.nonzero(cseg == qseg[r])[0]
        if len(cols) == 0:
            continue
        v, li = topk_numpy(x[r:r + 1], y[cols], min(k, len(cols)),
                           metric=metric)
        valid = li[0] >= 0
        m = int(valid.sum())
        vals[r, :m] = v[0][valid]
        idx[r, :m] = cols[li[0][valid]]
    return vals, idx


# --------------------------------------------------------------------- #
# device-side merge: segmented dedup + top-k fold over launch outputs
# --------------------------------------------------------------------- #

_ID_SENTINEL = 2 ** 31 - 1


def merge_topk_device(big_d: torch.Tensor, big_i: torch.Tensor,
                      sel: torch.Tensor, deleted: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-request merge of launch outputs on the device.

    ``big_d``/``big_i``: (T, W) stacked launch rows (distances + global
    ids, (+inf, -1) padding); ``sel``: (R, S) row indices — request r's
    pool is rows ``sel[r]`` flattened, in host-merge order.  Drops
    tombstones, stable-sorts by distance, keeps the first (closest)
    occurrence per id and cuts to k: bit-identical to the NumPy host
    merge and to the reference's ``merge_topk_device``."""
    r_n = sel.shape[0]
    d = big_d[sel].reshape(r_n, -1)
    i = big_i[sel].reshape(r_n, -1)
    dn = int(deleted.shape[0])
    dead = (i >= 0) & (i < dn) & deleted[i.long().clamp(0, max(dn - 1, 0))]
    bad = (i < 0) | dead | ~torch.isfinite(d)
    d = torch.where(bad, float("inf"), d)
    iu = torch.where(bad, _ID_SENTINEL, i)
    p1 = torch.argsort(d, dim=1, stable=True)
    ds, is_ = d.gather(1, p1), iu.gather(1, p1)
    p2 = torch.argsort(is_, dim=1, stable=True)   # ids grouped, d-order ties
    idg = is_.gather(1, p2)
    first = torch.cat([torch.ones_like(idg[:, :1], dtype=torch.bool),
                       idg[:, 1:] != idg[:, :-1]], 1)
    first = first & (idg != _ID_SENTINEL)
    keep = torch.zeros_like(first).scatter(1, p2, first)   # back to d-order
    rank = torch.cumsum(keep.long(), 1) - 1
    slot = torch.where(keep & (rank < k), rank, k)
    out_d = torch.full((r_n, k + 1), float("inf"), dtype=torch.float32,
                       device=d.device).scatter(1, slot, ds)
    out_i = torch.full((r_n, k + 1), -1, dtype=torch.int32,
                       device=d.device).scatter(
        1, slot, torch.where(is_ == _ID_SENTINEL, -1, is_).to(torch.int32))
    return out_d[:, :k], out_i[:, :k]


__all__ = ["bucket", "record_launch", "launch_stats", "reset_launch_stats",
           "pairwise_sqdist", "topk", "topk_segmented",
           "pad_descriptor_batch", "topk_segmented_desc", "topk_numpy",
           "topk_segmented_numpy", "merge_topk_device"]

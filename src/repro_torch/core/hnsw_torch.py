"""Batched level-0 HNSW beam search over (graph, query) pairs.

Port of ``hnsw_search_fused`` / ``hnsw_search_fused_filtered`` and
``_check_beam_capacity`` (``src/repro/core/hnsw_jax.py:219-270``).  The
reference vmaps a ``lax.while_loop`` over pairs and runs it as one
device program a size bucket.  On CUDA tensors the two entry points
launch ``beam_f32`` (``kernels/csrc/beam.cu``): one block a pair runs
the whole loop, one launch a bucket, no host round trip, at every shape
the reference takes (any ef >= k, 2M and d; no limit refuses a beam).
On CPU tensors they run ``_beam``, the plain PyTorch version and the
tests' oracle.

The kernel reads each neighbour row as (slot, global id) pairs, the
``neighbour_table`` of ``ids`` and ``level0``: ``beam_f32`` takes it in
place of ``level0``.  A CUDA runtime builds it once at upload
(``PackedRuntime.to_device``), keeps ``level0`` only as its slot plane
and passes it as the entry points' ``nbr``; they build it when a caller
passes none.  Placements follow from the shapes (``_beam_placement``,
cached a shape): the visited bitmaps in shared memory when a pair's
block stays within ``_SMEM_TWO_BLOCKS``, else in a global scratch; the
ef-list and result list in shared memory when they fit ``_SMEM_LIST``,
else in a per-pair global scratch, and then the query too when it does
not fit ``_SMEM_QUERY``.

``_beam`` keeps the whole batch in tensors of shape (P, ...): a vmapped
while loop runs the body on every lane and freezes each lane whose
condition is false, so it runs at most ``max_iter = 4·ef + 16`` steps,
applying each step only where the lane is still ``active``, and checks
``active.any()`` every 16 steps.

The reference's tie rules are kept by both: the expanded node is the
first minimum (``torch.argmin``, like ``jnp.argmin``), and each fold
orders ``[candidates, neighbours]`` stably, so on equal distance the
lower position wins as in ``lax.top_k``.  The visited update keeps the
reference's scatter semantics on the CPU: for repeated indices in one
neighbour row (padding ``-1`` clips to slot 0) the last write wins.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..kernels import _build
from ..kernels.distance_topk import (_METRICS, _require, check_inputs,
                                      vec_loads_ok)

_INF = float("inf")
_CHECK_EVERY = 16


def _check_beam_capacity(k: int, ef: int) -> None:
    """The beam's ef-list is the only result store: asking for more than
    ``ef`` results can only ever return (+inf, -1) padding past ef, so the
    executor's tombstone over-fetch must stay within this bound."""
    if k > ef:
        raise ValueError(
            f"k={k} exceeds the beam's ef-list capacity ef={ef}: slots "
            "past ef can never be filled.  Clamp the over-fetch to ef (the "
            "executor does) or raise ef_search")


def _topk_stable(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest per row, lower position first on ties."""
    return torch.argsort(vals, dim=1, stable=True)[:, :k]


def _beam(vectors, ids, level0, entry, gidx, queries, *, k: int, ef: int,
          max_iter: Optional[int], metric: str,
          masks: Optional[torch.Tensor] = None,
          midx: Optional[torch.Tensor] = None,
          visited_out: Optional[list] = None):
    """``visited_out``: receives each pair's visited slots, (P, n_max)
    bool (``beam_f32(stats=True)`` reports the same)."""
    p_n = int(gidx.shape[0])
    n = int(ids.shape[1])
    dev = queries.device
    if max_iter is None:
        max_iter = 4 * ef + 16
    gidx = gidx.long()
    q = queries.float()
    rows = torch.arange(p_n, device=dev)
    gcol = gidx[:, None]

    def global_of(slots: torch.Tensor) -> torch.Tensor:
        return ids[gcol, slots.clamp(0, n - 1)].long()

    def dist_of(slots: torch.Tensor) -> torch.Tensor:
        v = vectors[global_of(slots)].float()               # (P, m, d)
        if metric == "l2":
            diff = v - q[:, None, :]
            return (diff * diff).sum(-1)
        return -(v @ q[:, :, None])[..., 0]

    ent = entry[gidx].long()
    d0 = dist_of(ent[:, None])[:, 0]
    cand_s = torch.full((p_n, ef), -1, dtype=torch.long, device=dev)
    cand_s[:, 0] = ent
    cand_d = torch.full((p_n, ef), _INF, dtype=torch.float32, device=dev)
    cand_d[:, 0] = d0
    expanded = torch.zeros((p_n, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((p_n, n), dtype=torch.bool, device=dev)
    visited[rows, ent] = True
    filtered = masks is not None
    if filtered:
        mrow = midx.long()[:, None]

        def allowed_of(slots: torch.Tensor) -> torch.Tensor:
            return masks[mrow, global_of(slots)]

        ok0 = allowed_of(ent[:, None])[:, 0]
        res_d = torch.full((p_n, k), _INF, dtype=torch.float32, device=dev)
        res_s = torch.full((p_n, k), -1, dtype=torch.long, device=dev)
        res_d[:, 0] = torch.where(ok0, d0, _INF)
        res_s[:, 0] = torch.where(ok0, ent, -1)
    slot_pos = torch.arange(int(level0.shape[2]), device=dev)[None, None, :]

    def unexpanded(cd, cs, ex):
        return torch.where(ex | (cs < 0), _INF, cd)

    def cond(cd, cs, ex):
        best = unexpanded(cd, cs, ex).min(1).values
        worst = torch.where(cs < 0, -_INF, cd).max(1).values
        return torch.isfinite(best) & (best <= worst)

    active = cond(cand_d, cand_s, expanded)
    for it in range(max_iter):
        pick = unexpanded(cand_d, cand_s, expanded).argmin(1)
        ex = expanded.clone()
        ex[rows, pick] = True
        node = cand_s[rows, pick]
        nb = level0[gidx, node.clamp(0, n - 1)].long()      # (P, 2M)
        nbc = nb.clamp(0, n - 1)
        seen = visited.gather(1, nbc)
        valid = (nb >= 0) & ~seen
        nd = torch.where(valid, dist_of(nb), _INF)
        # scatter visited[nbc] = seen | (nb >= 0); repeated indices: the
        # last write wins, as the reference's scatter does on the CPU.
        # Every writer of an index writes the last writer's value, so
        # the scatter is deterministic on any device, with no host sync.
        same = nbc[:, :, None] == nbc[:, None, :]
        last = torch.where(same, slot_pos, -1).amax(2)
        vis = visited.scatter(1, nbc, (seen | (nb >= 0)).gather(1, last))
        all_d = torch.cat([cand_d, nd], 1)
        all_s = torch.cat([cand_s, torch.where(valid, nb, -1)], 1)
        all_e = torch.cat([ex, torch.zeros_like(valid)], 1)
        pos = _topk_stable(all_d, ef)
        a = active[:, None]
        cand_d = torch.where(a, all_d.gather(1, pos), cand_d)
        cand_s = torch.where(a, all_s.gather(1, pos), cand_s)
        expanded = torch.where(a, all_e.gather(1, pos), expanded)
        visited = torch.where(a, vis, visited)
        if filtered:
            keep = valid & allowed_of(nb)
            rd = torch.cat([res_d, torch.where(keep, nd, _INF)], 1)
            rs = torch.cat([res_s, torch.where(keep, nb, -1)], 1)
            rpos = _topk_stable(rd, k)
            res_d = torch.where(a, rd.gather(1, rpos), res_d)
            res_s = torch.where(a, rs.gather(1, rpos), res_s)
        active = active & cond(cand_d, cand_s, expanded)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(active.any()):
            break

    if visited_out is not None:
        visited_out.append(visited)
    if filtered:
        out_d, out_s = res_d, res_s
    else:
        kk = min(k, ef)
        pos = _topk_stable(cand_d, kk)
        out_d, out_s = cand_d.gather(1, pos), cand_s.gather(1, pos)
    out_g = torch.where(out_s >= 0, global_of(out_s), -1)
    out_d = torch.where(out_s >= 0, out_d, _INF)
    if out_d.shape[1] < k:
        pad = k - out_d.shape[1]
        out_d = torch.cat([out_d, out_d.new_full((p_n, pad), _INF)], 1)
        out_g = torch.cat([out_g, out_g.new_full((p_n, pad), -1)], 1)
    return out_d, out_g.to(torch.int32)


_SMEM_MAX = 232_448    # dynamic shared memory a block may use
_SMEM_TWO_BLOCKS = 113 * 1024   # the most with the bitmap in shared memory
_SMEM_LIST = _SMEM_MAX          # the most with the ef-list in shared memory
_SMEM_QUERY = _SMEM_MAX         # the most with the query in shared memory
_CH = 128                       # the kernel's neighbour chunk
_PROF = ("row", "dist", "fold", "barrier")


def neighbour_table(ids: torch.Tensor, level0: torch.Tensor) -> torch.Tensor:
    """(G, n_max, 2M, 2) int32: each neighbour's (slot, global id), the
    slot as in ``level0`` and its id ``ids[g, slot]`` (-1 where the slot
    is negative).  ``beam_f32`` reads a step's vectors straight from the
    row; a CUDA runtime builds it once at upload."""
    g_n, n = ids.shape
    slots = level0.to(torch.int32)
    gid = torch.gather(ids.to(torch.int32), 1,
                       slots.clamp(0, n - 1).reshape(g_n, -1).long())
    gid = torch.where(slots >= 0, gid.view(slots.shape), -1)
    return torch.stack([slots, gid], -1).contiguous()


def _beam_smem_bytes(d: int, ef: int, kr: int, m2: int, n: int,
                     smem_bitmap: bool, list_shared: bool = True,
                     query_shared: bool = True) -> int:
    """Dynamic shared memory of one ``beam_f32`` block (one pair): scalars
    and cycle counters, the query, the double-buffered ef-list and k-slot
    result list (``kr`` = k when filtered, else 0; 8 bytes an entry), a
    row chunk's valid neighbours and their keys (min(2M, 128) each) and,
    with ``smem_bitmap``, the visited bitmap of ``n`` slots.  Mirrors
    ``Layout`` in ``csrc/beam.cu``."""
    def r16(b):
        return (b + 15) // 16 * 16
    o = 96 + (r16(4 * d) if query_shared else 0)
    o += 16 * (ef + kr) if list_shared else 0
    o += 16 * min(m2, _CH)
    return r16(o) + (4 * (-(-n // 32)) if smem_bitmap else 0)


def _beam_placement(d: int, ef: int, kr: int, m2: int, n: int):
    """(bitmap, list, query) in shared memory, each True or False: the
    visited bitmap when the whole block fits ``_SMEM_TWO_BLOCKS`` (two
    blocks an SM), the ef-list and result list when the rest fits
    ``_SMEM_LIST``, else the query when what stays fits ``_SMEM_QUERY``.
    Each budget is at most ``_SMEM_MAX``."""
    return _placement(d, ef, kr, m2, n, _SMEM_TWO_BLOCKS, _SMEM_LIST,
                      _SMEM_QUERY)


@functools.lru_cache(maxsize=1024)
def _placement(d, ef, kr, m2, n, two_blocks, list_most, query_most):
    sbm = _beam_smem_bytes(d, ef, kr, m2, n, True) <= two_blocks
    ls = _beam_smem_bytes(d, ef, kr, m2, n, sbm) <= list_most
    qs = ls or _beam_smem_bytes(d, ef, kr, m2, n, sbm, False) <= query_most
    return sbm, ls, qs


def beam_f32(vectors, ids, nbr, entry, gidx, queries, *, k: int, ef: int,
             max_iter: Optional[int] = None, metric: str = "l2",
             masks: Optional[torch.Tensor] = None,
             midx: Optional[torch.Tensor] = None, stats: bool = False):
    """Launch ``csrc/beam.cu`` on CUDA tensors: the fused beam of every
    pair, ``_beam``'s contract (filtered when ``masks`` and ``midx`` are
    given) at any ef >= k, 2M and d.  ``nbr``: ``neighbour_table(ids,
    level0)`` in place of ``level0``.  Placements as
    ``_beam_placement`` says.  ``stats`` also returns a dict: ``bitmap``,
    ``list`` and ``query`` (``"shared"`` or ``"global"``, the placements
    taken), ``steps`` (P,) int32, ``expanded`` (P, max_iter) int32, the
    slot each step expanded (-1 after the last), ``visited`` (P, n_max)
    bool, each pair's visited slots, and ``cycles`` (P, 4) int64, the
    clock64() cycles of the first thread of each block's row warp by
    phase (``_PROF``: the step's start and its row's load, test and
    compaction; distances; fold, with the visited bits; waits at the
    block barriers).  ``launches`` counts the launches; there is no
    fallback: what the kernel does not take raises."""
    _check_beam_capacity(k, ef)
    _require(metric in _METRICS, f"unknown metric {metric!r}")
    dev = queries.device
    p, d = queries.shape
    v_n = vectors.shape[0]
    g_n, n = ids.shape
    m2 = nbr.shape[2]
    filtered = masks is not None
    _require(filtered == (midx is not None), "masks and midx go together")
    gidx = gidx.to(torch.int32)
    specs = [("vectors", vectors, torch.float32, (v_n, d)),
             ("ids", ids, torch.int32, (g_n, n)),
             ("nbr", nbr, torch.int32, (g_n, n, m2, 2)),
             ("entry", entry, torch.int32, (g_n,)),
             ("gidx", gidx, torch.int32, (p,)),
             ("queries", queries, torch.float32, (p, d))]
    if filtered:
        midx = midx.to(torch.int32)
        specs += [("masks", masks, torch.bool, tuple(masks.shape)),
                  ("midx", midx, torch.int32, (p,))]
        _require(masks.dim() == 2 and masks.shape[0] > 0
                 and masks.shape[1] >= v_n,
                 f"masks must be a (Mn, V) bitmap over the {v_n} rows of "
                 f"vectors, got {tuple(masks.shape)}")
    check_inputs(dev, specs)
    _require(min(p, d, v_n, g_n, n, m2, k) > 0, "empty beam input")
    _require(dev.type == "cuda", f"beam_f32 runs on CUDA tensors, not {dev}")
    if max_iter is None:
        max_iter = 4 * ef + 16
    kr = k if filtered else 0
    smem_bitmap, list_shared, query_shared = _beam_placement(d, ef, kr, m2,
                                                             n)
    vec = vec_loads_ok(queries, vectors)
    words = -(-n // 32)
    bits = (torch.empty((p, words), dtype=torch.int32, device=dev)
            if stats or not smem_bitmap else None)
    lists = (None if list_shared else
             torch.empty((p, 2 * (ef + kr), 2), dtype=torch.int32,
                         device=dev))
    out_d = torch.empty((p, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((p, k), dtype=torch.int32, device=dev)
    steps = torch.empty(p, dtype=torch.int32, device=dev) if stats else None
    expanded = (torch.empty((p, max_iter), dtype=torch.int32, device=dev)
                if stats else None)
    prof = (torch.empty((p, len(_PROF)), dtype=torch.int64, device=dev)
            if stats else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("beam_f32", lib.beam_f32(
        ptr(vectors), ptr(ids), ptr(nbr), ptr(entry), ptr(gidx),
        ptr(queries), ptr(masks), ptr(midx), p, d, n, m2, v_n, g_n,
        masks.shape[0] if filtered else 0, masks.shape[1] if filtered else 0,
        k, ef, max_iter, int(metric == "ip"), int(vec), int(smem_bitmap),
        int(list_shared), int(query_shared),
        None if smem_bitmap else ptr(bits), ptr(lists),
        ptr(out_d), ptr(out_i), ptr(steps), ptr(expanded), ptr(prof),
        ptr(bits) if smem_bitmap else None, stream))
    beam_f32.launches += 1
    if not stats:
        return out_d, out_i
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    visited = ((bits[:, :, None] >> shifts) & 1).bool().view(p, -1)[:, :n]
    place = {True: "shared", False: "global"}
    return out_d, out_i, {"bitmap": place[smem_bitmap],
                          "list": place[list_shared],
                          "query": place[query_shared],
                          "steps": steps, "expanded": expanded,
                          "visited": visited, "cycles": prof}


beam_f32.launches = 0


def hnsw_search_fused(vectors, ids, level0, entry, gidx, queries, *, k: int,
                      ef: int, max_iter: Optional[int] = None,
                      metric: str = "l2", nbr: Optional[torch.Tensor] = None):
    """Beam search over (graph, query) PAIRS of one size bucket.

    ``ids`` (G, n_max) local slot → global id (0-padded: padded slots are
    unreachable); ``level0`` (G, n_max, 2M) neighbour slots, -1 padded;
    ``entry`` (G,); ``gidx`` (P,) graph per pair; ``queries`` (P, d).
    Returns (P, k) ascending distances and global ids, (+inf, -1)
    unfilled.  CPU tensors run ``_beam``; CUDA tensors launch
    ``beam_f32`` on ``nbr`` (``neighbour_table(ids, level0)``, built
    here when not given)."""
    _check_beam_capacity(k, ef)
    if queries.device.type == "cpu":
        return _beam(vectors, ids, level0, entry, gidx, queries, k=k, ef=ef,
                     max_iter=max_iter, metric=metric)
    if nbr is None:
        nbr = neighbour_table(ids, level0)
    return beam_f32(vectors, ids, nbr, entry, gidx, queries, k=k, ef=ef,
                    max_iter=max_iter, metric=metric)


def hnsw_search_fused_filtered(vectors, ids, level0, entry, masks, midx,
                               gidx, queries, *, k: int, ef: int,
                               max_iter: Optional[int] = None,
                               metric: str = "l2",
                               nbr: Optional[torch.Tensor] = None):
    """Filtered variant: pair p searches graph ``gidx[p]`` under the
    bitmap ``masks[midx[p]]`` ((Mn, V) bool over global ids).  The
    traversal beam is unfiltered; a separate k-slot result list folds in
    allowed nodes only."""
    _check_beam_capacity(k, ef)
    if queries.device.type == "cpu":
        return _beam(vectors, ids, level0, entry, gidx, queries, k=k, ef=ef,
                     max_iter=max_iter, metric=metric, masks=masks,
                     midx=midx)
    if nbr is None:
        nbr = neighbour_table(ids, level0)
    return beam_f32(vectors, ids, nbr, entry, gidx, queries, k=k, ef=ef,
                    max_iter=max_iter, metric=metric, masks=masks, midx=midx)


__all__ = ["hnsw_search_fused", "hnsw_search_fused_filtered", "beam_f32",
           "neighbour_table", "_check_beam_capacity"]

"""Batched level-0 HNSW beam search over (graph, query) pairs, in PyTorch.

Port of ``hnsw_search_fused`` / ``hnsw_search_fused_filtered`` and
``_check_beam_capacity`` (``src/repro/core/hnsw_jax.py:219-270``).  The
reference vmaps a ``lax.while_loop`` over pairs; a vmapped while loop
runs the body on every lane and freezes each lane whose condition is
false, so this port keeps the whole batch in tensors of shape (P, ...)
and runs at most ``max_iter = 4·ef + 16`` steps, applying each step only
where the lane is still ``active``.  The host checks ``active.any()``
every 16 steps — one sync per 16 steps, not per step.

The reference's tie rules are kept: the expanded node is the first
minimum (``torch.argmin``, like ``jnp.argmin``), and each fold sorts
``[candidates, neighbours]`` with a stable sort, so on equal distance
the lower position wins as in ``lax.top_k``.  The visited update keeps
the reference's scatter semantics on the CPU: for repeated indices in
one neighbour row (padding ``-1`` clips to slot 0) the last write wins.

This is XLA code in the reference, not a Pallas kernel, so plain
PyTorch is a faithful port; a hand-written CUDA beam is queued.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    """``visited_out``: receives each pair's count of visited nodes (the
    vectors the search read), for a measurement of its bytes."""
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
        visited_out.append(visited.sum(1))
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


def hnsw_search_fused(vectors, ids, level0, entry, gidx, queries, *, k: int,
                      ef: int, max_iter: Optional[int] = None,
                      metric: str = "l2"):
    """Beam search over (graph, query) PAIRS of one size bucket.

    ``ids`` (G, n_max) local slot → global id (0-padded: padded slots are
    unreachable); ``level0`` (G, n_max, 2M) neighbour slots, -1 padded;
    ``entry`` (G,); ``gidx`` (P,) graph per pair; ``queries`` (P, d).
    Returns (P, k) ascending distances and global ids, (+inf, -1)
    unfilled."""
    _check_beam_capacity(k, ef)
    return _beam(vectors, ids, level0, entry, gidx, queries, k=k, ef=ef,
                 max_iter=max_iter, metric=metric)


def hnsw_search_fused_filtered(vectors, ids, level0, entry, masks, midx,
                               gidx, queries, *, k: int, ef: int,
                               max_iter: Optional[int] = None,
                               metric: str = "l2"):
    """Filtered variant: pair p searches graph ``gidx[p]`` under the
    bitmap ``masks[midx[p]]`` ((Mn, V) bool over global ids).  The
    traversal beam is unfiltered; a separate k-slot result list folds in
    allowed nodes only."""
    _check_beam_capacity(k, ef)
    return _beam(vectors, ids, level0, entry, gidx, queries, k=k, ef=ef,
                 max_iter=max_iter, metric=metric, masks=masks, midx=midx)


__all__ = ["hnsw_search_fused", "hnsw_search_fused_filtered",
           "_check_beam_capacity"]

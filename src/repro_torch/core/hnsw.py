# Verbatim copy of src/repro/core/hnsw.py (no imports of repro).
"""Array-form HNSW (Malkov & Yashunin) — host build, host + device search.

The paper uses stock HNSW as the per-state index (§2.2).  Adaptation for this
framework (DESIGN.md §2):

  * build is inherently sequential (each insert searches the graph built so
    far) and runs on the host with vectorized NumPy distance batches — the
    same placement the paper's C++ implementation uses;
  * the graph is stored as padded neighbour matrices (int32, -1 padded), so
    it serializes zero-copy into checkpoints and uploads to device untouched;
  * device search (`jax_search`) is a `lax.while_loop` beam search over the
    level-0 neighbour matrix with a fixed-size candidate list (ef) and a
    visited hash ring — the TPU-native replacement for heap-based best-first
    search (heaps don't vectorize; a sorted ef-list folded with
    `jax.lax.top_k` does).

Search quality contract: identical candidate-expansion rule as the reference
algorithm; host and device searches agree on recall within tie-breaking.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    diff = a - b
    return np.einsum("...d,...d->...", diff, diff)


class HNSW:
    """Hierarchical navigable small-world graph over a fixed vector table.

    ``vectors`` is the *global* vector table; the graph indexes the subset
    ``ids`` (global IDs).  This mirrors the paper's remark that all vectors
    live in one global array and per-state graphs store only IDs.
    """

    def __init__(self, vectors: np.ndarray, M: int = 16, ef_con: int = 200,
                 metric: str = "l2", seed: int = 0) -> None:
        self.vectors = vectors
        self.M = M
        self.M0 = 2 * M
        self.ef_con = ef_con
        self.metric = metric
        self._rng = np.random.default_rng(seed)
        self._ml = 1.0 / math.log(M)
        self.ids: List[int] = []                 # local slot -> global id
        self._ids_arr = np.empty(16, dtype=np.int64)   # capacity-doubled copy
        self.levels: List[int] = []              # local slot -> top level
        # neighbours[l] : (num_nodes_total, M_l) int32 local slots, -1 pad
        self.neighbors: List[np.ndarray] = []
        self.entry: int = -1
        self.max_level: int = -1
        self._deleted: set = set()               # lazy deletion (paper §5)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.ids)

    def _dist(self, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
        vecs = self.vectors[self._ids_arr[slots]]
        if self.metric == "l2":
            return _l2(vecs, q[None, :])
        return -(vecs @ q)

    def _neighbor_cap(self, level: int) -> int:
        return self.M0 if level == 0 else self.M

    def _ensure_level_arrays(self, level: int) -> None:
        while len(self.neighbors) <= level:
            l = len(self.neighbors)
            self.neighbors.append(
                np.full((len(self.ids), self._neighbor_cap(l)), -1,
                        dtype=np.int32))

    def _grow(self) -> None:
        for l, nb in enumerate(self.neighbors):
            if nb.shape[0] < len(self.ids):
                pad = np.full((len(self.ids) - nb.shape[0], nb.shape[1]), -1,
                              dtype=np.int32)
                self.neighbors[l] = np.concatenate([nb, pad], axis=0)

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    def add(self, global_id: int) -> None:
        """Insert one vector (by global ID) — standard HNSW insert."""
        q = self.vectors[global_id].astype(np.float32)
        slot = len(self.ids)
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self.ids.append(global_id)
        if slot >= len(self._ids_arr):
            grown = np.empty(2 * len(self._ids_arr), dtype=np.int64)
            grown[:slot] = self._ids_arr[:slot]
            self._ids_arr = grown
        self._ids_arr[slot] = global_id
        self.levels.append(level)
        self._ensure_level_arrays(level)
        self._grow()

        if self.entry == -1:
            self.entry = slot
            self.max_level = level
            return

        ep = self.entry
        # greedy descent through layers above `level`
        for l in range(self.max_level, level, -1):
            ep = self._greedy(q, ep, l)
        # ef-bounded search + connect at each layer <= level
        for l in range(min(level, self.max_level), -1, -1):
            cands = self._search_layer(q, [ep], l, self.ef_con)
            cap = self._neighbor_cap(l)
            chosen = self._select_neighbors(q, cands, cap)
            nb = self.neighbors[l]
            nb[slot, :len(chosen)] = chosen
            for c in chosen:
                row = nb[c]
                free = np.where(row == -1)[0]
                if len(free):
                    row[free[0]] = slot
                else:
                    # prune: keep cap best neighbours of c
                    cand_slots = np.concatenate([row, [slot]])
                    d = self._dist(self.vectors[self.ids[c]].astype(
                        np.float32), cand_slots)
                    keep = cand_slots[np.argsort(d, kind="stable")[:cap]]
                    nb[c] = keep.astype(np.int32)
            ep = chosen[0] if len(chosen) else ep
        if level > self.max_level:
            self.max_level = level
            self.entry = slot

    def build(self, global_ids: Sequence[int]) -> "HNSW":
        for g in global_ids:
            self.add(int(g))
        return self

    def _greedy(self, q: np.ndarray, ep: int, level: int) -> int:
        nb = self.neighbors[level]
        cur = ep
        cur_d = float(self._dist(q, np.asarray([cur]))[0])
        while True:
            neigh = nb[cur]
            neigh = neigh[neigh >= 0]
            if len(neigh) == 0:
                return cur
            d = self._dist(q, neigh)
            j = int(np.argmin(d))
            if d[j] < cur_d:
                cur, cur_d = int(neigh[j]), float(d[j])
            else:
                return cur

    def _search_layer(self, q: np.ndarray, eps: List[int], level: int,
                      ef: int) -> List[Tuple[float, int]]:
        """Best-first ef-bounded search; returns [(dist, slot)] ascending."""
        nb = self.neighbors[level]
        visited = set(eps)
        d0 = self._dist(q, np.asarray(eps))
        cand = [(float(d), int(s)) for d, s in zip(d0, eps)]   # min-heap
        heapq.heapify(cand)
        best = [(-float(d), int(s)) for d, s in zip(d0, eps)]  # max-heap
        heapq.heapify(best)
        while cand:
            d, s = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            neigh = nb[s]
            neigh = neigh[neigh >= 0]
            new = [int(x) for x in neigh if x not in visited]
            if not new:
                continue
            visited.update(new)
            dn = self._dist(q, np.asarray(new))
            for dd, ss in zip(dn, new):
                dd = float(dd)
                if len(best) < ef or dd < -best[0][0]:
                    heapq.heappush(cand, (dd, ss))
                    heapq.heappush(best, (-dd, ss))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted([(-d, s) for d, s in best])
        return out

    def _select_neighbors(self, q: np.ndarray,
                          cands: List[Tuple[float, int]], cap: int
                          ) -> List[int]:
        return [s for _, s in cands[:cap]]

    # ------------------------------------------------------------------ #
    # queries (host path)
    # ------------------------------------------------------------------ #

    def search(self, q: np.ndarray, k: int, ef_search: int,
               allowed: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances, global_ids), ascending, ≤ k entries.

        ``allowed`` — optional bool bitmap over GLOBAL ids (the packed
        executor's composed conjunct mask): the beam traverses the graph
        unfiltered but only allowed nodes are returned, mirroring the
        device path's in-loop bitmap filter."""
        if self.entry == -1:
            return (np.empty(0, np.float32), np.empty(0, np.int64))
        q = np.asarray(q, dtype=np.float32)
        ep = self.entry
        for l in range(self.max_level, 0, -1):
            ep = self._greedy(q, ep, l)
        res = self._search_layer(q, [ep], 0, max(ef_search, k))
        ids = self._ids_arr
        out_d, out_i = [], []
        for d, s in res:
            g = int(ids[s])
            if g in self._deleted:
                continue
            if allowed is not None and not allowed[g]:
                continue
            out_d.append(d)
            out_i.append(g)
            if len(out_i) == k:
                break
        return (np.asarray(out_d, np.float32), np.asarray(out_i, np.int64))

    def mark_deleted(self, global_id: int) -> None:
        self._deleted.add(global_id)

    # ------------------------------------------------------------------ #
    # device export
    # ------------------------------------------------------------------ #

    def pack(self) -> Dict[str, np.ndarray]:
        """Padded arrays for the JAX search path / checkpointing."""
        n = len(self.ids)
        level0 = (self.neighbors[0] if self.neighbors
                  else np.full((n, self.M0), -1, np.int32))
        return {
            "ids": np.asarray(self.ids, dtype=np.int32),
            "level0": level0.astype(np.int32),
            "entry": np.asarray([self.entry], dtype=np.int32),
            "levels": np.asarray(self.levels, dtype=np.int32),
        }

    @property
    def size_entries(self) -> int:
        """Index-size accounting: one entry per stored ID + per edge slot."""
        edges = sum(int((nb >= 0).sum()) for nb in self.neighbors)
        return len(self.ids) + edges

    # ------------------------------------------------------------------ #
    # full (re-loadable) serialization
    # ------------------------------------------------------------------ #

    def pack_full(self) -> Dict[str, np.ndarray]:
        out = {
            "ids": np.asarray(self.ids, dtype=np.int64),
            "levels": np.asarray(self.levels, dtype=np.int32),
            "meta": np.asarray([self.M, self.ef_con, self.entry,
                                self.max_level,
                                0 if self.metric == "l2" else 1,
                                len(self.neighbors)], dtype=np.int64),
            "deleted": np.asarray(sorted(self._deleted), dtype=np.int64),
        }
        for l, nb in enumerate(self.neighbors):
            out[f"nb{l}"] = nb
        return out

    @classmethod
    def from_packed(cls, vectors: np.ndarray, arrays: Dict[str, np.ndarray]
                    ) -> "HNSW":
        M, ef_con, entry, max_level, metric_i, n_levels = (
            int(x) for x in arrays["meta"])
        self = cls(vectors, M=M, ef_con=ef_con,
                   metric="l2" if metric_i == 0 else "ip")
        self.ids = [int(x) for x in arrays["ids"]]
        self._ids_arr = np.asarray(arrays["ids"], dtype=np.int64).copy()
        self.levels = [int(x) for x in arrays["levels"]]
        self.entry = entry
        self.max_level = max_level
        self.neighbors = [np.asarray(arrays[f"nb{l}"], dtype=np.int32).copy()
                          for l in range(n_levels)]
        self._deleted = set(int(x) for x in arrays["deleted"])
        return self

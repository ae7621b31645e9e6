# Copy of src/repro/core/baselines.py over the port's ESAM, HNSW and
# ops.topk_numpy (no imports of repro).
"""The paper's baselines (§3): OptQuery, PreFiltering, PostFiltering.

All three share the same substrate as VectorMaton (same ESAM for pattern
filtering where needed, same HNSW, same fused brute-force kernel), so the
benchmark comparisons measure the *algorithms*, not implementation deltas —
the paper makes the same argument when excusing ElasticSearch's JVM overhead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .esam import ESAM
from .hnsw import HNSW
from ..kernels import ops


class OptQuery:
    """Algorithm 1: one HNSW per *distinct pattern* in the collection —
    optimal query behaviour, O(m^2) space.

    ``max_pattern_len`` caps enumeration (None = all substrings, faithful but
    quadratic; benchmarks on larger corpora cap it the way the paper's OOM
    rows effectively do).  ``T`` applies the same raw-set floor VectorMaton
    uses so tiny patterns don't each pay a graph — this only *shrinks*
    OptQuery's reported size, i.e. is conservative for our comparisons.
    """

    def __init__(self, vectors: np.ndarray, sequences: Sequence[str],
                 M: int = 16, ef_con: int = 200, metric: str = "l2",
                 T: int = 0, max_pattern_len: Optional[int] = None,
                 seed: int = 0) -> None:
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.metric = metric
        self.patterns: Dict[object, np.ndarray] = {}
        per_pattern: Dict[object, set] = {}
        for sid, s in enumerate(sequences):
            L = len(s)
            seen = set()
            for i in range(L):
                hi = L if max_pattern_len is None else min(L, i + max_pattern_len)
                for j in range(i + 1, hi + 1):
                    p = s[i:j]
                    if isinstance(p, list):
                        p = tuple(p)
                    if p in seen:
                        continue
                    seen.add(p)
                    per_pattern.setdefault(p, set()).add(sid)
        self.graphs: Dict[object, HNSW] = {}
        self.raw: Dict[object, np.ndarray] = {}
        for rank, (p, ids) in enumerate(sorted(per_pattern.items(),
                                               key=lambda kv: str(kv[0]))):
            arr = np.asarray(sorted(ids), dtype=np.int64)
            self.patterns[p] = arr
            if len(arr) < T:
                self.raw[p] = arr
            else:
                self.graphs[p] = HNSW(self.vectors, M=M, ef_con=ef_con,
                                      metric=metric, seed=seed + rank
                                      ).build(arr)

    def query(self, v_q: np.ndarray, pattern, k: int, ef_search: int = 64
              ) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(pattern, list):
            pattern = tuple(pattern)
        if pattern not in self.patterns:
            return (np.empty(0, np.float32), np.empty(0, np.int64))
        if pattern in self.raw:
            ids = self.raw[pattern]
            d, li = ops.topk_numpy(np.asarray(v_q, np.float32)[None, :],
                                   self.vectors[ids], min(k, len(ids)),
                                   metric=self.metric)
            valid = li[0] >= 0
            return d[0][valid], ids[li[0][valid]]
        return self.graphs[pattern].search(np.asarray(v_q, np.float32), k,
                                           ef_search)

    def size_entries(self) -> int:
        s = sum(len(a) for a in self.raw.values())
        s += sum(g.size_entries for g in self.graphs.values())
        return s

    def num_insertions(self) -> int:
        """Σ_p |V_p| — the O(m^2) quantity of Theorem 1."""
        return sum(len(a) for a in self.patterns.values())


class PreFiltering:
    """Algorithm 2 (top): ESAM filter -> exact brute force over V_p."""

    def __init__(self, vectors: np.ndarray, sequences: Sequence[str],
                 metric: str = "l2") -> None:
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.metric = metric
        self.esam = ESAM()
        self.esam.add_sequences(sequences)
        self.esam.finalize()

    def query(self, v_q: np.ndarray, pattern, k: int, **_
              ) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.esam.ids_for_pattern(pattern)
        if len(ids) == 0:
            return (np.empty(0, np.float32), np.empty(0, np.int64))
        d, li = ops.topk_numpy(np.asarray(v_q, np.float32)[None, :],
                               self.vectors[ids], min(k, len(ids)),
                               metric=self.metric)
        valid = li[0] >= 0
        return d[0][valid], ids[li[0][valid]]

    def size_entries(self) -> int:
        return self.esam.num_states + self.esam.num_transitions


class PostFiltering:
    """Algorithm 2 (bottom): full-dataset HNSW search with ef_search
    candidates, then pattern filter, keep k."""

    def __init__(self, vectors: np.ndarray, sequences: Sequence[str],
                 M: int = 16, ef_con: int = 200, metric: str = "l2",
                 seed: int = 0) -> None:
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.sequences = list(sequences)
        self.metric = metric
        self.esam = ESAM()
        self.esam.add_sequences(sequences)
        self.esam.finalize()
        self.graph = HNSW(self.vectors, M=M, ef_con=ef_con, metric=metric,
                          seed=seed).build(range(len(self.vectors)))

    def query(self, v_q: np.ndarray, pattern, k: int, ef_search: int = 64
              ) -> Tuple[np.ndarray, np.ndarray]:
        v_q = np.asarray(v_q, np.float32)
        # retrieve ef_search candidates, then filter (Algorithm 2 lines 5-7)
        d, ids = self.graph.search(v_q, ef_search, ef_search)
        ok = self.esam.ids_for_pattern(pattern)
        if len(ok) == 0:
            return (np.empty(0, np.float32), np.empty(0, np.int64))
        mask = np.isin(ids, ok)
        d, ids = d[mask][:k], ids[mask][:k]
        return d, ids

    def size_entries(self) -> int:
        return (self.graph.size_entries + self.esam.num_states
                + self.esam.num_transitions)


def recall(result_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    """|V_o ∩ V_{k,p}| / k — the paper's answer-quality metric."""
    if len(truth_ids) == 0:
        return 1.0
    return len(set(result_ids.tolist()) & set(truth_ids.tolist())) / len(
        truth_ids)


def ground_truth(vectors: np.ndarray, esam_or_ids, pattern, v_q: np.ndarray,
                 k: int, metric: str = "l2") -> np.ndarray:
    """Exact V_{k,p} via ESAM filter + exact brute force."""
    if isinstance(esam_or_ids, np.ndarray):
        ids = esam_or_ids
    else:
        ids = esam_or_ids.ids_for_pattern(pattern)
    if len(ids) == 0:
        return np.empty(0, np.int64)
    d, li = ops.topk_numpy(np.asarray(v_q, np.float32)[None, :],
                           vectors[ids], min(k, len(ids)), metric=metric)
    valid = li[0] >= 0
    return ids[li[0][valid]]

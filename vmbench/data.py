"""Frozen generators of the benchmark's inputs, all drawn from ``--seed``.

What a configuration file states (rows, width, clusters, tags) and what a
traffic file states (predicate block, query noise, pool size) become
arrays here.  The program under test receives only these arrays; the
plain reference in ``reference.py`` receives the same ones.  Every size
is fixed by the files: a seed changes which rows carry which tags and
which vectors are drawn, never how many.

The scale corpus follows ``repro_torch/data/corpora.py``'s generator
(clustered Gaussians, tag strings with exact per-tag selectivities and a
terminal ``z``), with two changes: the seed also enters the tag hash, and
the rows are drawn on the device by a ``torch.Generator`` in a few large
calls.  This file is a copy, so that edits to the program's generator do
not move the benchmark.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ROW_BLOCK = 1 << 18          # rows drawn per generator call
_KNUTH = np.uint64(2654435761)
_PHI32 = np.uint64(0x9E3779B9)
_MASK32 = np.uint64(0xFFFFFFFF)

SALT_ROWS, SALT_TAGS, SALT_QUERIES, SALT_SCHEDULE = 1, 2, 3, 4


def sub_seed(seed: int, salt: int) -> int:
    """A 64-bit seed for one stream (rows, tags, ...) of ``seed``; any
    whole number is accepted."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), salt])
    return int(ss.generate_state(1, np.uint64)[0])


def make_rows(cfg: Dict, seed: int, device: str = "cuda"
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The configuration's (rows, dim) float32 table.

    Rows are ``centers[c] + noise · N(0, I)`` with ``c`` drawn uniformly
    over ``centers`` Gaussian centres; with ``normalize`` each row is then
    scaled to unit length.  Returns ``(table, raw_norms)``: the table as a
    host array, and the norm of each row before normalisation (None
    without it), which the query generator needs.  The stream depends only on the seed and the
    file's sizes, so a second call gives the same table."""
    n, d = int(cfg["rows"]), int(cfg["dim"])
    spec = cfg["vectors"]
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, SALT_ROWS))
    centers = torch.randn(int(spec["centers"]), d, generator=g,
                          device=device)
    assign = torch.randint(int(spec["centers"]), (n,), generator=g,
                           device=device)
    out = np.empty((n, d), np.float32)
    norms = np.empty(n, np.float32) if cfg.get("normalize") else None
    for start in range(0, n, ROW_BLOCK):
        stop = min(n, start + ROW_BLOCK)
        rows = centers[assign[start:stop]] + float(spec["noise"]) * \
            torch.randn(stop - start, d, generator=g, device=device)
        if norms is not None:
            nr = rows.norm(dim=1, keepdim=True)
            norms[start:stop] = nr[:, 0].cpu().numpy()
            rows = rows / nr
        out[start:stop] = rows.cpu().numpy()
    return out, norms


def _mix32(x: np.ndarray) -> np.ndarray:
    """Murmur3's 32-bit finaliser (as the program's scale corpus)."""
    x = x & _MASK32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _MASK32
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _MASK32
    return x ^ (x >> np.uint64(16))


def tag_codes(n: int, tags: Sequence[Tuple[str, float]],
              seed: int) -> np.ndarray:
    """Bit j of row i's code is set iff row i carries tag j: the hash of
    (i, j, seed) falls under the tag's selectivity, so each tag holds its
    stated share of the rows on every seed."""
    ids = np.arange(n, dtype=np.uint64)
    salt = np.uint64(sub_seed(seed, SALT_TAGS) & 0xFFFFFFFF)
    codes = np.zeros(n, np.int64)
    for j, (_, share) in enumerate(tags):
        h = _mix32(ids * _KNUTH + np.uint64(j) * _PHI32 + salt)
        codes |= (h < np.uint64(int(float(share) * 2 ** 32))).astype(
            np.int64) << j
    return codes


def sequences_of(codes: np.ndarray, tags: Sequence[Tuple[str, float]],
                 terminal: str) -> List[str]:
    """Each row's string: its tags in the configuration's order, then the
    terminal symbol."""
    names = [t for t, _ in tags]
    table = np.array(["".join(t for j, t in enumerate(names) if c >> j & 1)
                      + terminal for c in range(1 << len(names))],
                     dtype=object)
    return table[codes].tolist()


def make_queries(rows: np.ndarray, raw_norms: Optional[np.ndarray],
                 count: int, noise: float, seed: int) -> np.ndarray:
    """``count`` query vectors: a row drawn from the seed plus
    N(0, noise²) in the generator's space before normalisation; for a
    normalised table the query is normalised too."""
    rng = np.random.default_rng(sub_seed(seed, SALT_QUERIES))
    base = rng.integers(0, len(rows), size=count)
    q = rows[base].astype(np.float64)
    if raw_norms is not None:
        q *= raw_norms[base, None]
    q += noise * rng.standard_normal(q.shape)
    if raw_norms is not None:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.ascontiguousarray(q, dtype=np.float32)


class Schedule:
    """The request stream of a traffic mix: request i asks predicate
    ``pred(i)`` with query vector ``i mod pool``.  The mix's block (each
    predicate with its count) is shuffled anew for every block of
    requests, so every seed sends the same predicates in the same
    proportions, in another order."""

    def __init__(self, traffic: Dict, seed: int) -> None:
        self._base = np.repeat(np.arange(len(traffic["block"])),
                               [int(c) for _, c in traffic["block"]])
        self._rng = np.random.default_rng(sub_seed(seed, SALT_SCHEDULE))
        self.pool = int(traffic["query_pool"])
        self._block: np.ndarray = np.empty(0, np.int64)
        self._pos = 0
        self.issued = 0

    def next(self) -> Tuple[int, int, int]:
        """(request number, predicate index, query index)."""
        if self._pos == len(self._block):
            self._block = self._rng.permutation(self._base)
            self._pos = 0
        p = int(self._block[self._pos])
        self._pos += 1
        i = self.issued
        self.issued += 1
        return i, p, i % self.pool

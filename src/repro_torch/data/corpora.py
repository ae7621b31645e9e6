# Verbatim copy of src/repro/data/corpora.py (no imports of repro).
"""Synthetic corpora mirroring the paper's six datasets in *shape*.

Offline container ⇒ no Hugging Face / SpamAssassin downloads; each corpus
reproduces the structural statistics that drive VectorMaton behaviour —
n, total sequence length, alphabet size, repeat structure, embedding dim —
with a deterministic RNG.  Table 2 analogue (scaled to CPU budgets):

    name        n      total len   dim   alphabet / flavour
    spam       489      ~13.6k     384   word-like email subjects
    words     2000      ~14k        64   short letter strings
    mtg       3000     ~210k        96   sentence-like descriptions
    prot      1500     ~380k        64   20-symbol amino-acid strings
    code      4000     ~90k         96   identifier-style camelCase

Sequences are generated from small Zipf vocabularies of reusable chunks so
that substrings repeat across records — the property that makes the
paper's equivalence-class compression (and the near-linear empirical index
growth of Fig. 11) kick in.  Vectors are unit-normal with mild cluster
structure (64 gaussian centers) so HNSW recall curves behave like real
embeddings.
"""

from __future__ import annotations

import string
import zlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class CorpusSpec:
    name: str
    n: int
    dim: int
    mean_len: int
    alphabet: str
    chunky: bool = True    # build sequences from a shared chunk vocabulary


SPECS = {
    "spam": CorpusSpec("spam", 489, 384, 28, string.ascii_lowercase + " "),
    "words": CorpusSpec("words", 2000, 64, 7,
                        string.ascii_lowercase, chunky=False),
    "mtg": CorpusSpec("mtg", 3000, 96, 70, string.ascii_lowercase + " "),
    "prot": CorpusSpec("prot", 1500, 64, 255, "ACDEFGHIKLMNPQRSTVWY"),
    "code": CorpusSpec("code", 4000, 96, 22,
                       string.ascii_letters + "_"),
}


def _chunk_vocab(rng: np.random.Generator, alphabet: str, n_chunks: int,
                 lo: int, hi: int) -> List[str]:
    return ["".join(rng.choice(list(alphabet), size=rng.integers(lo, hi)))
            for _ in range(n_chunks)]


def make_corpus(name: str, seed: int = 0, scale: float = 1.0
                ) -> Tuple[np.ndarray, List[str]]:
    """Returns (vectors (n, dim) float32, sequences list[str])."""
    spec = SPECS[name]
    # crc32, not hash(): str hashing is randomized per process
    # (PYTHONHASHSEED), which silently regenerated a different corpus
    # every run — any cross-run baseline pinned on corpus content was
    # comparing apples to oranges
    rng = np.random.default_rng(np.random.SeedSequence(
        [zlib.crc32(name.encode()) % 2 ** 31, seed]))
    n = max(8, int(spec.n * scale))

    # --- sequences -----------------------------------------------------
    seqs: List[str] = []
    if spec.chunky:
        vocab = _chunk_vocab(rng, spec.alphabet, max(64, n // 8), 3, 9)
        ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.05
        p /= p.sum()
        for _ in range(n):
            target = max(3, int(rng.normal(spec.mean_len,
                                           spec.mean_len / 3)))
            parts: List[str] = []
            cur = 0
            while cur < target:
                w = vocab[rng.choice(len(vocab), p=p)]
                parts.append(w)
                cur += len(w)
            seqs.append("".join(parts)[:target + 8])
    else:
        for _ in range(n):
            ln = max(2, int(rng.normal(spec.mean_len, 2)))
            seqs.append("".join(rng.choice(list(spec.alphabet), size=ln)))

    # --- vectors (clustered gaussians) ----------------------------------
    n_centers = 64
    centers = rng.standard_normal((n_centers, spec.dim)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=n)
    vecs = (centers[assign]
            + 0.5 * rng.standard_normal((n, spec.dim))).astype(np.float32)
    return vecs, seqs


# --------------------------------------------------------------------- #
# real-scale streamed corpus (BENCH_PR6, DESIGN.md §6)
#
# The paper-shape corpora above top out at a few thousand records; the
# scalability frontier needs 10^5–10^6 vectors at 128–768 dims without
# blowing CI memory at generation time.  Vectors stream out in fixed
# blocks, each regenerable independently from (seed, block index), so
# an oracle scan can re-derive any block without holding the table.
#
# Pattern structure is synthetic-but-exact: record i carries tag
# character t_j iff
#
#     ((i · 2654435761 + j · 0x9E3779B9) mod 2^32)  <  s_j · 2^32
#
# (Knuth multiplicative hash), giving each tag an exact, id-decidable
# selectivity s_j.  A record's sequence is its present tags in a fixed
# order plus a terminal 'z', so substring membership (what the ESAM
# indexes) is decidable per id and pattern selectivities compose:
# "ab" ≈ s_a·s_b, "e" stays rare, "az" means "a and nothing between".
# --------------------------------------------------------------------- #

SCALE_TAGS: List[Tuple[str, float]] = [
    ("a", 0.50), ("b", 0.25), ("c", 0.10), ("d", 0.04), ("e", 0.01)]
# frontier query mix: selectivities ~0.5 .. ~0.01 via tag composition
SCALE_PATTERNS = ["a", "b", "c", "d", "e", "ab", "bc", "cz"]
_KNUTH = np.uint64(2654435761)
_PHI32 = np.uint64(0x9E3779B9)
_MASK32 = np.uint64(0xFFFFFFFF)
SCALE_BLOCK = 8192


def _mix32(x: np.ndarray) -> np.ndarray:
    """Avalanche finish (murmur3-style): without it the per-tag offsets
    stay linearly correlated and composed patterns like "bc" get
    selectivity 0 instead of s_b·s_c."""
    x = x & _MASK32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _MASK32
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _MASK32
    return x ^ (x >> np.uint64(16))


def scale_tag_member(ids: np.ndarray, tag_index: int,
                     selectivity: float) -> np.ndarray:
    """Exact per-id tag membership under the Knuth-hash rule."""
    h = _mix32(ids.astype(np.uint64) * _KNUTH
               + np.uint64(tag_index) * _PHI32)
    return h < np.uint64(int(selectivity * 2 ** 32))


def scale_sequences(n: int) -> List[str]:
    """Tag strings for ids 0..n-1 (deterministic, seed-free)."""
    ids = np.arange(n, dtype=np.uint64)
    members = [scale_tag_member(ids, j, s)
               for j, (_, s) in enumerate(SCALE_TAGS)]
    tags = [t for t, _ in SCALE_TAGS]
    return ["".join(t for t, m in zip(tags, row) if m) + "z"
            for row in zip(*(m.tolist() for m in members))]


def _scale_centers(dim: int, seed: int,
                   n_centers: int = 256) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC5]))
    return rng.standard_normal((n_centers, dim)).astype(np.float32)


def stream_scale_vectors(n: int, dim: int, seed: int = 0,
                         block: int = SCALE_BLOCK):
    """Yield ``(start, (b, dim) float32)`` blocks of the scale corpus.

    Block b depends only on ``(seed, b)`` — cluster assignment is the
    same Knuth hash over ids — so a streamed consumer (oracle scan,
    sharded loader) regenerates any block in O(block·dim) memory."""
    centers = _scale_centers(dim, seed)
    for start in range(0, n, block):
        stop = min(n, start + block)
        ids = np.arange(start, stop, dtype=np.uint64)
        assign = ((ids * _KNUTH + 7 * _PHI32) & _MASK32) % len(centers)
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 1 + start // block]))
        noise = rng.standard_normal((stop - start, dim)).astype(np.float32)
        yield start, centers[assign.astype(np.int64)] + 0.5 * noise


def make_scale_corpus(n: int, dim: int, seed: int = 0
                      ) -> Tuple[np.ndarray, List[str]]:
    """Materialized (vectors, sequences) — the index build needs the
    full table resident anyway; callers that only scan should iterate
    ``stream_scale_vectors`` instead."""
    vecs = np.empty((n, dim), np.float32)
    for start, blk in stream_scale_vectors(n, dim, seed):
        vecs[start:start + len(blk)] = blk
    return vecs, scale_sequences(n)


def sample_patterns(seqs: List[str], length: int, count: int,
                    seed: int = 0) -> List[str]:
    """Query patterns sampled from substrings that actually occur
    (paper §6.1 'Queries')."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, length]))
    out = []
    long_enough = [s for s in seqs if len(s) >= length]
    for _ in range(count):
        s = long_enough[rng.integers(0, len(long_enough))]
        i = rng.integers(0, len(s) - length + 1)
        out.append(s[i:i + length])
    return out

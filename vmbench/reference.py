"""Plain reference of filtered top-k, the control, and the comparison
that decides ``correct``.

Written from the semantics, not from the program: a predicate parser and
matcher of its own (``CONTAINS``, ``LIKE`` with ``%`` / ``_`` / ``\\``,
``AND``, ``OR``, ``NOT``, parentheses; a string with no keyword, quote
or parenthesis is a verbatim ``CONTAINS``), and an exact top-k that
ranks every matching row.  It imports torch and numpy only: nothing of
the program and nothing of JAX.

Exact top-k: per predicate, the fp32 distances of a block of queries to
every matching row (TF32 off), the ``k + MARGIN`` smallest of them, then
their distances again in float64 in difference form; the k smallest of
those, ties to the lower id, are the answer.  Distances are the
program's: squared L2 for ``l2``, minus the inner product for ``ip``.

The control is the same scan at the next precision down from the fp32
that the configurations state: TF32 products (on a card the tensor
cores, on a CPU the operands rounded to TF32's 10-bit mantissa), with no
float64 re-rank.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MARGIN = 16                  # extra fp32 candidates re-ranked in float64
CHUNK_ELEMS = 1 << 28        # distance-matrix elements per block

# ------------------------------------------------------------------ #
# predicates
# ------------------------------------------------------------------ #

KEYWORDS = ("AND", "OR", "NOT", "LIKE", "CONTAINS")


class PredicateError(ValueError):
    pass


def _tokens(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(text):
        c = text[i]
        if c.isspace():
            i += 1
        elif c in "()":
            out.append((c, c))
            i += 1
        elif c == "'":
            buf, j = [], i + 1
            while True:
                if j >= len(text):
                    raise PredicateError(f"unterminated quote in {text!r}")
                if text[j] == "'":
                    if j + 1 < len(text) and text[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            out.append(("str", "".join(buf)))
            i = j + 1
        else:
            j = i
            while j < len(text) and not (text[j].isspace()
                                         or text[j] in "()'"):
                j += 1
            word = text[i:j]
            out.append(("kw" if word in KEYWORDS else "word", word))
            i = j
    return out


def like_regex(pattern: str) -> "re.Pattern":
    """SQL LIKE: ``%`` any run, ``_`` one symbol, ``\\`` escapes the
    next character; the whole string must match."""
    parts, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            parts.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        parts.append(".*" if c == "%" else "." if c == "_"
                     else re.escape(c))
        i += 1
    return re.compile("".join(parts), re.DOTALL)


def parse(text: str):
    """A predicate as nested tuples: ``("contains", s)``,
    ``("like", regex)``, ``("and", a, b)``, ``("or", a, b)``,
    ``("not", a)``."""
    toks = _tokens(text)
    if not any(k in ("kw", "str", "(", ")") for k, _ in toks):
        return ("contains", text)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else (None, None)

    def take():
        t = peek()
        pos[0] += 1
        return t

    def expr():
        node = conj()
        while peek() == ("kw", "OR"):
            take()
            node = ("or", node, conj())
        return node

    def conj():
        node = unary()
        while peek() == ("kw", "AND"):
            take()
            node = ("and", node, unary())
        return node

    def unary():
        if peek() == ("kw", "NOT"):
            take()
            return ("not", unary())
        return atom()

    def atom():
        kind, val = take()
        if kind == "(":
            node = expr()
            if take()[0] != ")":
                raise PredicateError(f"missing ')' in {text!r}")
            return node
        if kind == "kw" and val in ("LIKE", "CONTAINS"):
            k2, lit = take()
            if k2 != "str":
                raise PredicateError(f"{val} needs a quoted literal")
            return (("like", like_regex(lit)) if val == "LIKE"
                    else ("contains", lit))
        if kind in ("word", "str"):
            return ("contains", val)
        raise PredicateError(f"unexpected {val!r} in {text!r}")

    node = expr()
    if pos[0] != len(toks):
        raise PredicateError(f"trailing tokens in {text!r}")
    return node


def matches(node, seq: str) -> bool:
    op = node[0]
    if op == "contains":
        return node[1] in seq
    if op == "like":
        return node[1].fullmatch(seq) is not None
    if op == "and":
        return matches(node[1], seq) and matches(node[2], seq)
    if op == "or":
        return matches(node[1], seq) or matches(node[2], seq)
    return not matches(node[1], seq)


class Matcher:
    """Rows matching a predicate, evaluated once per distinct sequence."""

    def __init__(self, sequences: Sequence[str]) -> None:
        groups: Dict[str, List[int]] = {}
        for i, s in enumerate(sequences):
            groups.setdefault(s, []).append(i)
        self.n = len(sequences)
        self._groups = [(s, np.asarray(ids, np.int64))
                        for s, ids in groups.items()]

    def member(self, text: str) -> np.ndarray:
        node = parse(text)
        out = np.zeros(self.n, bool)
        for s, ids in self._groups:
            if matches(node, s):
                out[ids] = True
        return out


# ------------------------------------------------------------------ #
# exact top-k and the control
# ------------------------------------------------------------------ #

def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, nearest-even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _products(x: torch.Tensor, y: torch.Tensor, tf32: bool) -> torch.Tensor:
    if x.device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return x @ y.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    if tf32:
        return _tf32_round(x) @ _tf32_round(y).T
    return x @ y.T


def _fp32_dist(x: torch.Tensor, y: torch.Tensor, y2: Optional[torch.Tensor],
               metric: str, tf32: bool) -> torch.Tensor:
    dots = _products(x, y, tf32)
    if metric == "l2":
        return ((x * x).sum(1, keepdim=True) + y2[None, :]
                - 2.0 * dots).clamp_min_(0.0)
    return dots.neg_()


def dist64(table: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
           metric: str) -> torch.Tensor:
    """float64 distances, difference form, of query row r to ids[r, j]
    (ids must be valid)."""
    v = table[ids].double()
    qd = q.double()[:, None, :]
    if metric == "l2":
        return ((v - qd) ** 2).sum(-1)
    return -(v * qd).sum(-1)


@dataclass
class Answers:
    """(R, k) ids, -1 padded, and their distances (NaN padded)."""
    ids: np.ndarray
    dist: np.ndarray


def topk(table: torch.Tensor, rows: np.ndarray, queries: np.ndarray, k: int,
         metric: str, control: bool = False) -> Answers:
    """Filtered top-k of ``queries`` over ``rows`` of ``table`` (a tensor
    on the device the reference runs on).  Exact by default; with
    ``control`` the TF32 scan, its fp32 values reported as they are."""
    dev = table.device
    nq = len(queries)
    kk = min(k, len(rows))
    ids = np.full((nq, k), -1, np.int64)
    dist = np.full((nq, k), np.nan, np.float64)
    if nq == 0 or kk == 0:
        return Answers(ids, dist)
    rows_t = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
    y = table[rows_t]
    y2 = (y * y).sum(1) if metric == "l2" else None
    m = kk if control else min(len(rows), k + MARGIN)
    step = max(1, CHUNK_ELEMS // len(rows))
    for a in range(0, nq, step):
        b = min(nq, a + step)
        x = torch.from_numpy(np.ascontiguousarray(queries[a:b])).to(dev)
        d32 = _fp32_dist(x, y, y2, metric, tf32=control)
        val, pos = torch.topk(d32, m, dim=1, largest=False)
        del d32
        cand = rows_t[pos]
        if control:
            order = torch.sort(val, dim=1, stable=True).indices
            ids[a:b, :kk] = cand.gather(1, order).cpu().numpy()
            dist[a:b, :kk] = val.gather(1, order).double().cpu().numpy()
            continue
        d64 = dist64(table, cand, x, metric)
        # ties to the lower id: sort by id, then stably by distance
        by_id = torch.sort(cand, dim=1).indices
        cand, d64 = cand.gather(1, by_id), d64.gather(1, by_id)
        order = torch.sort(d64, dim=1, stable=True).indices[:, :kk]
        ids[a:b, :kk] = cand.gather(1, order).cpu().numpy()
        dist[a:b, :kk] = d64.gather(1, order).cpu().numpy()
    return Answers(ids, dist)


# ------------------------------------------------------------------ #
# the comparison
# ------------------------------------------------------------------ #

@dataclass
class Verdict:
    """The requests that failed and the run's numbers beside their
    limits."""
    failed: int
    numbers: Dict[str, List[float]]   # name -> [reading, limit]
    correct: bool


def scales(queries: np.ndarray, max_sq_norm: float,
           metric: str) -> np.ndarray:
    """The size of the terms of each query's distances: ||q||² + max
    ||x||² for l2, ||q||·max ||x|| for ip.  Gaps and errors are read as
    shares of it."""
    qn = np.linalg.norm(queries.astype(np.float64), axis=1)
    if metric == "l2":
        return qn ** 2 + max_sq_norm
    return qn * np.sqrt(max_sq_norm)


def judge_requests(table: torch.Tensor, queries: np.ndarray,
                   pred_of: np.ndarray, members: List[np.ndarray],
                   got: Answers, exact: Answers, max_sq_norm: float,
                   metric: str, limits: Dict[str, float]) -> Verdict:
    """Hold ``got`` (the answers under test, in returned order) to
    ``exact`` request by request.

    * ``missing``: min(k, |V_p|) less the distinct matching ids returned;
    * ``foreign``: ids returned that are out of range, repeated or not
      matching the request's predicate;
    * ``rank_gap``: the largest, over ranks, of the float64 distance of
      the id returned at that rank above the exact answer's at that rank,
      as a share of ``scales``;
    * ``dist_err``: the largest gap between a reported distance and the
      float64 distance of its id, as a share of ``scales``.

    A request fails when any reading passes its limit; ``correct`` when
    none does and some request was judged."""
    nq, k = got.ids.shape
    n = len(table)
    if exact.ids.shape[1] < k:       # answers longer than asked
        pad = k - exact.ids.shape[1]
        exact = Answers(np.pad(exact.ids, ((0, 0), (0, pad)),
                               constant_values=-1),
                        np.pad(exact.dist, ((0, 0), (0, pad)),
                               constant_values=np.nan))
    scale = scales(queries, max_sq_norm, metric)
    missing = np.zeros(nq, np.int64)
    foreign = np.zeros(nq, np.int64)
    gap = np.zeros(nq)
    err = np.zeros(nq)
    ids = got.ids
    valid = ids >= 0
    in_range = valid & (ids < n)
    safe = np.where(in_range, ids, 0)
    d64 = np.zeros((nq, k))
    dev = table.device
    step = max(1, (1 << 22) // k)
    for a in range(0, nq, step):
        b = min(nq, a + step)
        d64[a:b] = dist64(
            table, torch.from_numpy(safe[a:b]).to(dev),
            torch.from_numpy(np.ascontiguousarray(queries[a:b])).to(dev),
            metric).cpu().numpy()
    good = np.zeros_like(valid)
    for p, mask in enumerate(members):
        rs = np.nonzero(pred_of == p)[0]
        if len(rs):
            good[rs] = in_range[rs] & mask[safe[rs]]
    for j in range(1, k):            # a repeated id counts once as good
        for i in range(j):
            good[:, j] &= ~(valid[:, i] & (ids[:, i] == ids[:, j]))
    expect = (exact.ids >= 0).sum(1)
    n_good = good.sum(1)
    missing[:] = np.maximum(0, expect - n_good)
    foreign[:] = valid.sum(1) - n_good
    ex_ok = exact.ids >= 0
    with np.errstate(invalid="ignore"):
        rank = np.where(good & ex_ok, d64 - np.nan_to_num(exact.dist), 0.0)
        rep = np.where(good, np.abs(got.dist - d64), 0.0)
    gap[:] = np.maximum(rank.max(1), 0.0) / scale
    err[:] = np.nan_to_num(rep, nan=np.inf).max(1) / scale
    bad = ((missing > limits["missing"]) | (foreign > limits["foreign"])
           | (gap > limits["rank_gap"]) | (err > limits["dist_err"]))
    numbers = {
        "missing": [float(missing.sum()), float(limits["missing"])],
        "foreign": [float(foreign.sum()), float(limits["foreign"])],
        "rank_gap": [float(gap.max()) if nq else 0.0,
                     float(limits["rank_gap"])],
        "dist_err": [float(err.max()) if nq else 0.0,
                     float(limits["dist_err"])],
    }
    failed = int(bad.sum())
    return Verdict(failed, numbers, correct=(failed == 0 and nq > 0))

# Verbatim copy of src/repro/core/planner.py (no imports of repro).
"""Selectivity-aware adaptive planner (DESIGN.md §11).

Strategy choice used to be a static compile-time rule: two constants in
``core/predicate.py`` (``FILTERED_GRAPH_MIN_KEEP`` / ``FILTERED_GRAPH_
MIN_FRAC``) plus the ``|V_state|`` threshold.  The filtered-ANNS
literature (FAVOR, the attribute-filtering experimental study — see
PAPERS.md) shows the win/lose boundary between "filter then scan" and
"search then filter" is workload-dependent: it moves with corpus size,
dimensionality, beam width, and — on a real host — with cache pressure
and kernel launch overhead that no compile-time constant can see.  This
module is the piece that closes the loop:

  * ``SelectivityEstimator`` — composes *exact* automaton-state /
    pseudo-state sizes through the boolean structure.  Leaves are exact
    (``|V_state|`` for CONTAINS via Lemma 4 chain covers, attribute
    rank-window widths for Tag/Range); And/Or/Not propagate interval
    bounds (Fréchet); conjunctions whose upper bound crosses a size
    cutoff are tightened by sampled bitmap popcounts over a fixed
    pseudo-random row sample.  Every estimate is an ``Interval`` —
    ``lo <= |members| <= hi`` always holds (asserted by tests).
  * ``CostModel`` — per-strategy cost curves ``setup + unit_cost ×
    units`` (launch setup amortization + bytes moved + expected verify
    work), where ``unit_cost`` is an EWMA per (strategy × log2 size
    bucket) *seeded from calibration defaults* (the BENCH_PR10
    selectivity sweep) so cold plans are sane.  Executors report
    observed (strategy, units, ms) triples; the pending observations
    fold into the EWMA only at wave heads (``absorb``), so a
    generation-stamped plan is immutable once compiled.
  * ``AdaptivePlanner`` — the object ``VectorMaton`` owns (it survives
    compactions, so feedback accumulates across generations).  The
    compiler consults it per conjunction source; executors feed it.

Exactness contract: the planner only ever arbitrates between strategies
with *identical result semantics*.  ``scan`` is exact over the composed
conjunction mask, so demoting a static ``filtered_graph`` choice to
``scan`` can only improve recall — the planner never promotes a static
``scan`` into a beam search, because beam recall is part of the static
contract the oracle suites pin down.  Likewise the residual switch
(doubling over-fetch → full scan) changes *when* ranking work happens,
never what verified set comes back.  ``plan_mode="static"`` disables
every adaptive decision and is the bit-exactness parity oracle.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Interval", "SelectivityEstimator", "CostModel",
           "AdaptivePlanner", "EF_NOMINAL"]

# nominal beam width used to convert "one filtered_graph source" into
# cost units at compile time (the actual ef arrives only at execute)
EF_NOMINAL = 64


@dataclass(frozen=True)
class Interval:
    """Cardinality bounds for one predicate node: lo <= |members| <= hi.
    ``exact`` marks lo == hi by construction (leaf sizes, not sampling).
    ``pt`` carries a sampled point estimate when one exists — the
    bracket stays the proven bound, but the scaled popcount is a far
    better scoring point than any midpoint of a wide band."""
    lo: int
    hi: int
    exact: bool
    pt: Optional[int] = None

    @property
    def point(self) -> int:
        """Point estimate for cost scoring: the sampled popcount when
        present, else the geometric midpoint — an additive midpoint of
        a wide [0, n] interval would pin every unknown at n/2, while
        selectivities are closer to log-uniform."""
        if self.exact or self.lo == self.hi:
            return self.hi
        if self.pt is not None:
            return min(max(self.pt, self.lo), self.hi)
        return int(round(math.sqrt(max(self.lo, 1) * max(self.hi, 1))))


class SelectivityEstimator:
    """Interval cardinality estimates composed through boolean structure.

    The compiler ultimately materializes exact masks for the strategies
    it emits; the estimator's job is the *decision* input — a bound that
    is cheap relative to mask materialization and provably brackets the
    truth, so the cost model can score strategies before committing.
    Sampling reuses the compile context's leaf-mask caches (the same
    masks ``_node_mask`` builds), restricted to a fixed deterministic
    row sample, so a tightened conjunction estimate costs
    O(children × SAMPLE_SIZE) on top of work the compile does anyway.
    """

    # tighten And intervals only when the upper bound is large enough
    # that materializing the exact mask is the expensive path: above
    # SAMPLE_CUTOFF absolutely, or above max(SAMPLE_SIZE, n/8) on small
    # corpora — mid-size conjunctions are exactly the fg-vs-scan
    # decision zone, and sampling costs O(children x SAMPLE_SIZE)
    SAMPLE_CUTOFF = 2048
    SAMPLE_SIZE = 512

    def __init__(self) -> None:
        self.n_estimates = 0
        self.n_sampled = 0

    # ------------------------------------------------------------------ #
    def _sample_ids(self, n: int) -> np.ndarray:
        k = min(self.SAMPLE_SIZE, n)
        # deterministic low-discrepancy sample: evenly spaced with a
        # fixed golden-ratio offset, so repeated compiles of the same
        # predicate estimate identically (resume/replay safety)
        step = n / k
        return np.minimum((np.arange(k) * step + 0.382 * step).astype(
            np.int64), n - 1)

    def _leaf_interval(self, node, ctx) -> Interval:
        from .predicate import Contains, Like, Not, Range, Tag
        n = ctx.n
        if isinstance(node, Contains):
            st = ctx.walk(node.pattern)
            if st == -1:
                return Interval(0, 0, True)
            c = ctx.cover_size(st)
            return Interval(c, c, True)
        if isinstance(node, (Tag, Range)):
            segs, _, _, frozen = ctx.attr_segments(node)
            c = frozen + len(ctx.attr_delta_ids(node))
            return Interval(c, c, True)
        if isinstance(node, Like):
            # each maximal literal run is a necessary CONTAINS: the true
            # member set is inside the intersection of their covers, so
            # min cover size is an upper bound; nothing lower-bounds a
            # wildcard pattern short of verification
            lits = node.literals()
            if not lits:
                return Interval(0, n, False)
            hi = n
            for lit in lits:
                st = ctx.walk(lit)
                if st == -1:
                    return Interval(0, 0, True)
                hi = min(hi, ctx.cover_size(st))
            return Interval(0, hi, False)
        if isinstance(node, Not):
            inner = self.estimate(node.child, ctx)
            return Interval(n - inner.hi, n - inner.lo, inner.exact)
        raise TypeError(f"unknown leaf {node!r}")

    def _sample_mask(self, node, ctx, ids: np.ndarray
                     ) -> Optional[np.ndarray]:
        """Membership of ``ids`` under a node whose mask is exact, or
        None when the node has no exact mask (Like residuals)."""
        from .predicate import And, Contains, Not, Or, Range, Tag
        if isinstance(node, Contains):
            st = ctx.walk(node.pattern)
            if st == -1:
                return np.zeros(len(ids), dtype=bool)
            return ctx.cover_mask(st)[ids]
        if isinstance(node, (Tag, Range)):
            return ctx.attr_mask(node)[ids]
        if isinstance(node, Not):
            m = self._sample_mask(node.child, ctx, ids)
            return None if m is None else ~m
        if isinstance(node, And):
            out = np.ones(len(ids), dtype=bool)
            for c in node.children:
                m = self._sample_mask(c, ctx, ids)
                if m is None:
                    return None
                out &= m
            return out
        if isinstance(node, Or):
            out = np.zeros(len(ids), dtype=bool)
            for c in node.children:
                m = self._sample_mask(c, ctx, ids)
                if m is None:
                    return None
                out |= m
            return out
        return None

    def estimate(self, node, ctx) -> Interval:
        """Interval cardinality of ``node`` against the compile context
        (``predicate._Ctx`` — duck-typed: n / walk / cover_size /
        cover_mask / attr_segments / attr_delta_ids / attr_mask)."""
        from .predicate import And, Or
        self.n_estimates += 1
        n = ctx.n
        if isinstance(node, And):
            from .predicate import Contains
            kids = list(node.children)
            # substring implication: CONTAINS(p) is implied by
            # CONTAINS(q) whenever p is a substring of q, so the
            # shorter pattern adds no constraint — prune it.  A
            # conjunction that collapses to one child is that child's
            # (often exact) interval.
            drop = set()
            for i, c in enumerate(kids):
                if not isinstance(c, Contains):
                    continue
                for j, d in enumerate(kids):
                    if (i != j and j not in drop and isinstance(d, Contains)
                            and c.pattern != d.pattern
                            and c.pattern in d.pattern):
                        drop.add(i)
                        break
            kids = [c for i, c in enumerate(kids) if i not in drop]
            if len(kids) == 1:
                return self.estimate(kids[0], ctx)
            children = [self.estimate(c, ctx) for c in kids]
            hi = min(c.hi for c in children)
            # Fréchet lower bound: |∩| >= Σ|c| - (k-1)·n
            lo = max(0, sum(c.lo for c in children) - (len(children) - 1) * n)
            exact = False
            pt = None
            cutoff = min(self.SAMPLE_CUTOFF,
                         max(self.SAMPLE_SIZE, n // 8))
            if hi > lo and hi >= cutoff:
                ids = self._sample_ids(n)
                m = self._sample_mask(node, ctx, ids)
                if m is not None:
                    self.n_sampled += 1
                    # scaled popcount, clamped into the proven interval —
                    # sampling tightens the bracket, never widens it.
                    # The band is the worst-case +/-2 sigma binomial
                    # width (sigma_max = n*sqrt(0.25/k)); the
                    # low-discrepancy sample is typically far tighter,
                    # but the band must keep the truth inside the
                    # bracket, not just center on it
                    p = int(round(m.mean() * n))
                    half = max(1, int(round(n * math.sqrt(1.0 / len(ids)))))
                    lo = max(lo, min(hi, p - half))
                    hi = min(hi, max(lo, p + half))
                    pt = p
            return Interval(lo, hi, exact, pt)
        if isinstance(node, Or):
            children = [self.estimate(c, ctx) for c in node.children]
            lo = max(c.lo for c in children)
            hi = min(n, sum(c.hi for c in children))
            return Interval(lo, hi, False)
        return self._leaf_interval(node, ctx)


class CostModel:
    """Per-strategy cost curves with runtime feedback.

    ``score(strategy, units)`` returns estimated milliseconds:
    ``setup + unit_cost(bucket(units)) * units``.  ``setup`` covers the
    fixed per-source overhead (trace/dispatch of an extra launch class,
    mask upload for filtered beams); ``unit_cost`` is ms per unit of
    strategy work — a candidate row for scans/residuals, a beam step
    (ef slots × graphs) for filtered_graph — maintained as an EWMA per
    (strategy × log2 size bucket).

    Seeds are calibration defaults measured by the BENCH_PR10
    selectivity sweep on the CI host (single-core CPU jax), so a cold
    planner scores sanely; measured EWMAs take over per bucket once
    ``MIN_OBS`` waves folded in.  Observations are buffered thread-safely
    and folded only by ``absorb()`` — the wave-head cadence that keeps
    dispatched plans immutable (DESIGN.md §11).
    """

    ALPHA = 0.25              # EWMA smoothing per fold
    MIN_OBS = 4               # folds before a bucket's EWMA is trusted
    MARGIN = 1.4              # measured advantage required to demote
    NEAR_BUCKETS = 2          # nearest-bucket fallback radius

    # calibration defaults: ms per work unit / ms per source launch
    # (BENCH_PR10 sweep, CPU jax; relative order is what matters cold —
    # a beam slot costs ~an order more than a scanned row, and a graph
    # source pays mask-upload + an extra launch class of setup)
    DEFAULT_UNIT = {"scan": 2.0e-4, "filtered_graph": 2.0e-3,
                    "residual": 2.0e-4, "verify": 2.0e-3}
    DEFAULT_SETUP = {"scan": 0.05, "filtered_graph": 0.40,
                     "residual": 0.10, "verify": 0.0}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: List[Tuple[str, int, float]] = []
        self._ewma: Dict[Tuple[str, int], float] = {}
        self._obs: Dict[Tuple[str, int], int] = {}
        self.folds = 0

    @staticmethod
    def bucket(units: int) -> int:
        return max(0, int(units).bit_length() - 1)

    # ---- feedback ----------------------------------------------------- #
    def observe(self, strategy: str, units: int, ms: float) -> None:
        """Record one executed work item.  Called from executor code —
        possibly on the pipeline's executor thread — so it only appends;
        folding happens at the next wave head."""
        if units <= 0 or ms < 0:
            return
        with self._lock:
            self._pending.append((strategy, int(units), float(ms)))

    def absorb(self) -> int:
        """Fold pending observations into the per-bucket EWMAs.  Returns
        the number of observations folded (planner_feedback_updates)."""
        with self._lock:
            batch, self._pending = self._pending, []
        for strategy, units, ms in batch:
            key = (strategy, self.bucket(units))
            per_unit = ms / units
            prev = self._ewma.get(key)
            self._ewma[key] = (per_unit if prev is None
                               else (1 - self.ALPHA) * prev
                               + self.ALPHA * per_unit)
            self._obs[key] = self._obs.get(key, 0) + 1
        self.folds += len(batch)
        return len(batch)

    # ---- scoring ------------------------------------------------------ #
    def unit_cost(self, strategy: str, units: int
                  ) -> Tuple[float, bool]:
        """(ms per unit, measured?) — the bucket's EWMA when trusted,
        else the nearest trusted bucket within NEAR_BUCKETS, else the
        calibration default."""
        b = self.bucket(units)
        for dist in range(self.NEAR_BUCKETS + 1):
            for bb in ((b,) if dist == 0 else (b - dist, b + dist)):
                key = (strategy, bb)
                if self._obs.get(key, 0) >= self.MIN_OBS:
                    return self._ewma[key], True
        return self.DEFAULT_UNIT.get(strategy, 1.0e-3), False

    def score(self, strategy: str, units: int) -> Tuple[float, bool]:
        """(estimated ms for one source of ``units`` work, measured?)."""
        unit, measured = self.unit_cost(strategy, units)
        return (self.DEFAULT_SETUP.get(strategy, 0.1) + unit * units,
                measured)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Measured state for calibration dumps (BENCH_PR10.json)."""
        with self._lock:
            return {f"{s}/b{b}": {"unit_ms": self._ewma[(s, b)],
                                  "obs": self._obs[(s, b)]}
                    for (s, b) in sorted(self._ewma)}


class AdaptivePlanner:
    """The per-index planner: estimator + cost model + measured winners.

    Owned by ``VectorMaton`` (NOT by a ``PackedRuntime`` generation), so
    feedback survives compactions; each built runtime carries a
    reference.  All strategy arbitration respects the exactness contract
    in the module docstring: the scored set for a conjunction is
    {static choice} ∪ {scan} — ``scan`` is always result-safe, and
    ``filtered_graph`` is only legal where the static rule selects it.
    """

    MODES = ("adaptive", "static")

    def __init__(self, mode: str = "adaptive") -> None:
        if mode not in self.MODES:
            raise ValueError(
                f"unknown plan_mode {mode!r} (expected one of {self.MODES})")
        self.mode = mode
        self.estimator = SelectivityEstimator()
        self.cost = CostModel()
        self._lock = threading.Lock()
        # (pred key, delta version) -> measured winning strategy; the
        # pred-cache entry mirrors this so a re-compiled predicate
        # replays its measured winner at the same delta version
        self._winners: Dict[Tuple[str, int], str] = {}
        self.force_strategy: Optional[str] = None   # tests/benchmarks
        self.counters: Dict[str, int] = {
            "scored": 0,            # conjunction sources cost-scored
            "estimates": 0,         # estimator intervals produced
            "est_checked": 0,       # estimates compared to exact counts
            "est_within_2x": 0,     # ... whose point est was within 2×
            "feedback_updates": 0,  # observations folded into the EWMA
            "absorbs": 0,           # wave heads that folded feedback
            "demotions": 0,         # filtered_graph -> scan by cost
            "residual_switches": 0,  # doubling loop -> full scan
            "cache_replays": 0,     # measured winner replayed at compile
        }

    # ------------------------------------------------------------------ #
    @property
    def adaptive(self) -> bool:
        return self.mode == "adaptive"

    # ---- feedback plumbing -------------------------------------------- #
    def observe(self, strategy: str, units: int, ms: float) -> None:
        if self.adaptive:
            self.cost.observe(strategy, units, ms)

    def absorb(self) -> None:
        """Wave-head fold: the ONLY place observations mutate the cost
        model, so plans dispatched mid-wave never see state move under
        them (DESIGN.md §11 feedback cadence)."""
        if not self.adaptive:
            return
        folded = self.cost.absorb()
        with self._lock:
            self.counters["absorbs"] += 1
            self.counters["feedback_updates"] += folded

    @property
    def pending_feedback(self) -> int:
        return len(self.cost._pending)

    # ---- estimator bookkeeping ---------------------------------------- #
    def record_estimate(self, iv: Interval, actual: int) -> None:
        """Compare an interval's point estimate against the exact count
        the compiler went on to materialize (estimates-vs-observed
        counters; the BENCH_PR10 gate reads the within-2× ratio)."""
        with self._lock:
            self.counters["estimates"] += 1
            self.counters["est_checked"] += 1
            p = max(1, iv.point)
            a = max(1, int(actual))
            if max(p / a, a / p) <= 2.0:
                self.counters["est_within_2x"] += 1

    # ---- strategy arbitration ----------------------------------------- #
    def choose_conjunction(self, *, key: str, version: int, sel: int,
                           n_graphs: int, static_strategy: str) -> str:
        """Pick the strategy for one conjunction source.  ``sel`` is the
        (estimated) surviving candidate count, ``n_graphs`` the anchor's
        graph-state count, ``static_strategy`` what the legacy rule
        picks.  Static mode returns it untouched (parity oracle)."""
        if not self.adaptive:
            return static_strategy
        legal = ({"scan", "filtered_graph"}
                 if static_strategy == "filtered_graph" else {"scan"})
        with self._lock:
            self.counters["scored"] += 1
            forced = self.force_strategy
            winner = self._winners.get((key, version))
        if forced in legal:
            return forced
        if winner in legal and winner != static_strategy:
            with self._lock:
                self.counters["cache_replays"] += 1
            return winner
        if static_strategy != "filtered_graph":
            return "scan"
        c_scan, scan_meas = self.cost.score("scan", max(1, sel))
        c_fg, fg_meas = self.cost.score(
            "filtered_graph", max(1, n_graphs) * EF_NOMINAL)
        # demote only on MEASURED evidence with margin: cold priors must
        # reproduce the static rule exactly, so plan_mode parity holds
        # until real feedback says otherwise
        if scan_meas and fg_meas and c_scan * self.cost.MARGIN < c_fg:
            with self._lock:
                self.counters["demotions"] += 1
                self._winners[(key, version)] = "scan"
            return "scan"
        return "filtered_graph"

    # ---- residual escalation ------------------------------------------ #
    def note_residual_switch(self, key: str, version: int) -> None:
        """The doubling loop's yield collapsed and execution escalated to
        the full scan; remember it so re-compiles at this delta version
        start there (pred-cache ``winning_strategy`` replay)."""
        with self._lock:
            self.counters["residual_switches"] += 1
            self._winners[(str(key), int(version))] = "residual_full"

    def residual_full(self, key: str, version: int) -> bool:
        """Should a residual source compiled for (key, version) start at
        the full prefilter scan?  True replays a measured switch."""
        if not self.adaptive:
            return False
        with self._lock:
            if self._winners.get((str(key), int(version))) == "residual_full":
                self.counters["cache_replays"] += 1
                return True
        return False

    def winner_for(self, key: str, version: int) -> Optional[str]:
        with self._lock:
            return self._winners.get((str(key), int(version)))

    # ---- observability ------------------------------------------------ #
    def stats(self) -> Dict[str, object]:
        """planner_* counters merged into ``maintenance_stats``."""
        with self._lock:
            out: Dict[str, object] = {
                f"planner_{k}": v for k, v in self.counters.items()}
        out["planner_mode"] = self.mode
        out["planner_pending_feedback"] = self.pending_feedback
        out["planner_cost_folds"] = self.cost.folds
        return out

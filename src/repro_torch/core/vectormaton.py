"""VectorMaton — pattern-constrained ANNS index (paper §4).

Port of ``src/repro/core/vectormaton.py``: the same index, built and
maintained on the host, whose query path runs on PyTorch tensors on
``VectorMatonConfig.device`` (``backend="torch"``, the default) or on
the NumPy host oracle (``backend="numpy"``).  With ``device="cuda"``
and no card the constructor raises; it never continues on the CPU.
``save`` / ``load`` write and read the reference's checkpoint format
(``distributed/checkpoint.py``), so checkpoints cross between packages.

Build (Algorithm 3 Build):
  1. ESAM over the sequence collection, with online vector-ID propagation.
  2. Reverse-topological sweep over the transition DAG.  For each state u:
       - index-reuse: inherit(u) = the direct successor with the largest
         covered set; base(u) = V_u \\ V_inherit(u)   (Lemma 4 exact cover —
         coverage is defined recursively along the inheritance chain, so the
         union of base sets along u's chain is exactly V_u);
       - skip-build: |base(u)| < T  ->  raw ID set (brute-force at query
         time); otherwise an HNSW graph over base(u).

Query (Algorithm 3 Query, extended to boolean predicates): handled by the
predicate compiler + planner/executor runtime (core/predicate.py,
core/packed.py, DESIGN.md §3).  At finalize time the chain structure and
per-state indexes are flattened into struct-of-arrays form (CSR base-ID
segments + padded graph matrices, uploaded to device once); at query time
each request's predicate — a plain CONTAINS pattern or an AND/OR/NOT/LIKE
string — compiles to per-disjunct execution sources (chain / scan /
filtered-graph / residual), identical predicates coalesce, and a batched
executor answers all brute-forced candidate sets with ONE segmented fused
distance+top-k launch, all shared graphs with vmapped (optionally
bitmap-filtered) beam searches, and residual LIKEs with an over-fetch +
host-verify loop.  ``query`` is the single-request special case of
``query_batch``.

Maintenance (paper §5, extended by DESIGN.md §4 "Write path"): online
insert extends the automaton and patches the affected base indexes without
a global rebuild — and without invalidating the packed query runtime: the
flattened ``PackedRuntime`` is an immutable *generation*, inserts land in
its append-only delta (growable vector buffer + per-state delta ID lists),
and a threshold-triggered *compaction* folds delta + tombstone GC into a
fresh generation swapped in behind the readers.  Deletes are lazy marks
filtered at query time and physically GC'd at compaction.

Parallel build mirrors the paper's concurrent ready-queue over reverse
topological order (thread pool; NumPy releases the GIL inside distance
batches).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .esam import ESAM, ROOT
from .hnsw import HNSW
from .packed import PackedRuntime, QueryPlan, VectorStore
from .planner import AdaptivePlanner
from .predicate import CompiledPredicate, Predicate, as_predicate, \
    compile_predicate

_RAW = 0
_HNSW = 1


@dataclass
class VectorMatonConfig:
    T: int = 200                 # skip-build threshold (paper default)
    M: int = 16                  # HNSW max degree
    ef_con: int = 200            # HNSW construction beam
    metric: str = "l2"
    reuse: bool = True           # index-reuse strategy (ablation switch)
    skip_build: bool = True      # skip-build strategy (ablation switch)
    seed: int = 0
    backend: str = "torch"       # 'torch' device path | 'numpy' host oracle
    device: str = "cuda"         # where the torch backend runs
    # 'sq8' (default): int8 scan + certified fp32 rerank on the torch scan
    # path — provably equal to the fp32 scan (batches whose certificate
    # fails escalate to it); 'none': fp32 scan only.  Ineligible shapes
    # (see kernels.quant.sq8_supported) fall back to fp32 transparently.
    quantize: str = "sq8"
    accum: str = "f32"           # 'bf16': bf16 MXU operands, f32 accum
    # write path (DESIGN.md §4): fold the delta into a fresh generation
    # once it holds max(compact_min_inserts, compact_ratio · |base|)
    # inserts; auto_compact=False leaves compaction to explicit compact()
    compact_min_inserts: int = 256
    compact_ratio: float = 0.25
    auto_compact: bool = True
    # typed attribute schema (DESIGN.md §9): field name -> 'tag' | 'numeric'.
    # Declared fields are indexed at freeze/compact into per-attribute
    # sorted-ID CSR segments and become queryable via comparison syntax
    # ("genre = 'rock' AND price < 10"); undeclared fields raise at
    # predicate compile time.  None = no structured attributes.
    schema: Optional[Dict[str, str]] = None
    # strategy arbitration (DESIGN.md §11): 'adaptive' scores every legal
    # strategy per conjunction source with the cost model and folds
    # executor feedback at wave heads; 'static' keeps every legacy
    # compile-time decision — the bit-exactness parity oracle.  Adaptive
    # never changes WHAT a plan returns, only WHICH exact strategy runs.
    plan_mode: str = "adaptive"


def check_config(config: VectorMatonConfig) -> None:
    """Refuse a backend this port does not have, and a CUDA device on a
    machine without one (the torch backend never falls back to the
    CPU)."""
    if config.backend not in ("torch", "numpy"):
        raise ValueError(f"unknown backend {config.backend!r} (expected "
                         "'torch' or 'numpy')")
    if config.backend == "torch":
        dev = torch.device(config.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"VectorMatonConfig.device={config.device!r} but CUDA is "
                "not available; pass device='cpu' to run the port's plain "
                "PyTorch path on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {config.device!r}")


@dataclass
class _StateIndex:
    kind: int                    # _RAW | _HNSW
    raw_ids: Optional[np.ndarray] = None
    graph: Optional[HNSW] = None

    @property
    def n_indexed(self) -> int:
        return (len(self.raw_ids) if self.kind == _RAW else len(self.graph))

    @property
    def size_entries(self) -> int:
        return (len(self.raw_ids) if self.kind == _RAW
                else self.graph.size_entries)


class VectorMaton:
    """The paper's index.  ``vectors``: (n, d) global table; ``sequences``:
    list of symbol sequences (strings or lists)."""

    def __init__(self, vectors: np.ndarray, sequences: Sequence[Sequence],
                 config: Optional[VectorMatonConfig] = None,
                 workers: int = 1,
                 attributes: Optional[Sequence[Dict]] = None) -> None:
        self.config = config or VectorMatonConfig()
        check_config(self.config)
        for f, kind in (self.config.schema or {}).items():
            if kind not in ("tag", "numeric"):
                raise ValueError(
                    f"schema field {f!r}: unknown type {kind!r} "
                    f"(expected 'tag' or 'numeric')")
        self.vectors = vectors                   # adopted into a VectorStore
        self.esam = ESAM()
        self.inherit: List[int] = []
        self.state_index: List[Optional[_StateIndex]] = []
        self.deleted: set = set()
        self.sequences: List = list(sequences)   # LIKE residual verification
        if attributes is not None and len(attributes) != len(sequences):
            raise ValueError(
                f"attributes ({len(attributes)}) must align with "
                f"sequences ({len(sequences)})")
        # one dict per record; schema-declared fields are type-coerced so
        # the frozen sorted arrays and host verification agree exactly
        self.attributes: List[Dict] = [
            self._norm_attrs(a) for a in (attributes or [])]
        self.attributes.extend({} for _ in range(
            len(self.sequences) - len(self.attributes)))
        self._lock = threading.Lock()
        self._compact_lock = threading.Lock()
        self.runtime_builds = 0                  # full re-flatten count
        self.n_compactions = 0
        self._gen_seq = 0                        # next generation number
        # owned by the index, NOT the runtime: cost-model feedback and
        # measured winners survive compactions (DESIGN.md §11).  Raises
        # on an unknown plan_mode before any build work happens.
        self.planner = AdaptivePlanner(self.config.plan_mode)
        for s in sequences:
            self.esam.add_sequence(s)
        self.esam.finalize()
        self._build_state_indexes(workers=workers)
        self._runtime: Optional[PackedRuntime] = self._build_runtime()

    def _norm_attrs(self, attrs: Optional[Dict]) -> Dict:
        """Coerce schema-declared fields (numeric -> float, tag -> str) so
        frozen sorted arrays, delta evaluation, and host verification all
        compare the same representation; undeclared keys pass through."""
        out = dict(attrs or {})
        for f, kind in (self.config.schema or {}).items():
            if f in out:
                out[f] = float(out[f]) if kind == "numeric" else str(out[f])
        return out

    # ------------------------------------------------------------------ #
    # vector storage (growable, capacity-doubling — DESIGN.md §4)
    # ------------------------------------------------------------------ #

    @property
    def vectors(self) -> np.ndarray:
        """Live (n, d) view of the growable vector table.  Re-fetched by
        readers after every insert (a buffer reallocation moves it)."""
        return self._vec_store.view

    @vectors.setter
    def vectors(self, table: np.ndarray) -> None:
        self._vec_store = VectorStore(table)

    # ------------------------------------------------------------------ #
    # index construction (Algorithm 3 lines 17-21)
    # ------------------------------------------------------------------ #

    def _pick_inherit(self, u: int) -> int:
        """Direct successor with the largest covered set (== |V_succ|)."""
        if not self.config.reuse:
            return -1
        best, best_size = -1, 0
        for v in self.esam.trans[u].values():
            sz = len(self.esam.state_ids(v))
            if sz > best_size:
                best, best_size = v, sz
        return best

    def _base_ids(self, u: int, h: int) -> np.ndarray:
        vu = self.esam.state_ids(u)
        if h == -1:
            return vu
        vh = self.esam.state_ids(h)
        # V_h ⊆ V_u (DAG monotonicity) — difference by sorted merge.
        return np.setdiff1d(vu, vh, assume_unique=True)

    def _build_one(self, u: int) -> _StateIndex:
        h = self.inherit[u]
        base = self._base_ids(u, h)
        cfg = self.config
        if cfg.skip_build and len(base) < cfg.T:
            return _StateIndex(_RAW, raw_ids=base)
        if len(base) == 0:
            return _StateIndex(_RAW, raw_ids=base)
        g = HNSW(self.vectors, M=cfg.M, ef_con=cfg.ef_con, metric=cfg.metric,
                 seed=cfg.seed + u)
        g.build(base)
        return _StateIndex(_HNSW, graph=g)

    def _build_state_indexes(self, workers: int = 1) -> None:
        n = self.esam.num_states
        self.inherit = [self._pick_inherit(u) for u in range(n)]
        self.state_index = [None] * n
        if workers <= 1:
            for u in self.esam.topo_order()[::-1]:
                self.state_index[int(u)] = self._build_one(int(u))
            return
        self._parallel_build(workers)

    def _parallel_build(self, workers: int) -> None:
        """Paper §4.3 'parallel construction': a concurrent ready-queue over
        reverse topological order.  A state is ready once all its transition
        successors are built (its base set only depends on V sets, but we
        keep the paper's dependency schedule so online-reuse variants that
        consult successor indexes stay correct)."""
        n = self.esam.num_states
        remaining = np.zeros(n, dtype=np.int64)
        preds: List[List[int]] = [[] for _ in range(n)]
        for u in range(n):
            succs = self.esam.trans[u].values()
            remaining[u] = len(succs)
            for v in succs:
                preds[v].append(u)
        ready: "queue_mod.Queue[int]" = queue_mod.Queue()
        for u in range(n):
            if remaining[u] == 0:
                ready.put(u)
        done = threading.Event()
        n_done = [0]

        def worker() -> None:
            while not done.is_set():
                try:
                    u = ready.get(timeout=0.05)
                except queue_mod.Empty:
                    continue
                idx = self._build_one(u)
                with self._lock:
                    self.state_index[u] = idx
                    n_done[0] += 1
                    if n_done[0] == n:
                        done.set()
                    for p in preds[u]:
                        remaining[p] -= 1
                        if remaining[p] == 0:
                            ready.put(p)

        threads = [threading.Thread(target=worker) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # ------------------------------------------------------------------ #
    # query processing (Algorithm 3 Query)
    # ------------------------------------------------------------------ #

    def _chain(self, state: int) -> List[int]:
        out = []
        u = state
        while u != -1:
            out.append(u)
            u = self.inherit[u]
        return out

    def _build_runtime(self) -> PackedRuntime:
        """One full re-flatten = one generation.  Counted: the churn
        acceptance criterion is builds == compactions, not inserts."""
        rt = PackedRuntime.build(self, generation=self._gen_seq)
        self._gen_seq += 1
        self.runtime_builds += 1
        return rt

    @property
    def runtime(self) -> PackedRuntime:
        """The current generation.  Inserts do NOT invalidate it — they
        land in its delta; only a compaction (or a checkpoint restore)
        produces a new one."""
        if self._runtime is None:
            self._runtime = self._build_runtime()
        return self._runtime

    def snapshot(self) -> PackedRuntime:
        """The current immutable generation (plus its delta).  Readers
        take one snapshot per batch: a plan compiled against it executes
        against it, so a concurrent compaction swap can never split plan
        and execute across generations (execute() enforces this)."""
        return self.runtime

    def _refresh_runtime(self) -> None:
        """Invalidate wholesale (checkpoint restore); the ordinary write
        path goes through the delta + compact() instead."""
        self._runtime = None

    _PRED_CACHE_MAX = 256        # entries can hold O(n) id arrays/masks

    def compile(self, pattern,
                runtime: Optional[PackedRuntime] = None) -> CompiledPredicate:
        """Lower a request pattern — a plain CONTAINS pattern, a predicate
        string (``"ab AND NOT LIKE 'c%d'"``), or a ``Predicate`` — to
        executable sources against ``runtime`` (default: current
        snapshot).  Compiled predicates are cached per (runtime, delta
        version): an insert bumps the delta version so stale plans (whose
        delta id lists miss the newest writes) recompile; deletes are
        tombstone-filtered at execute time and don't.  The cache is
        bounded: compiled boolean sources carry O(n) id arrays, so a
        serving stream of ever-distinct predicates must not grow it
        without bound.  Eviction is LRU with a stale-first sweep: a hit
        refreshes recency (hot predicates survive a thrash of distinct
        cold ones), and entries stamped with an outdated delta version —
        dead weight that can never hit again — are purged before any
        live entry is evicted."""
        pred = as_predicate(pattern)
        rt = runtime if runtime is not None else self.runtime
        key = pred.key()
        version = rt.delta.version
        planner = self.planner
        hit = rt._pred_cache.get(key)
        if hit is not None:
            if (hit[0] == version
                    and hit[2] == planner.winner_for(hit[1].key, version)):
                rt._pred_cache.pop(key)          # re-insert: LRU refresh
                rt._pred_cache[key] = hit
                return hit[1]
            # version-stale, or the planner measured a winning strategy
            # after this entry compiled (residual yield collapse,
            # cost-model demotion) — recompile so the plan replays it
            del rt._pred_cache[key]
        cp = compile_predicate(pred, self.esam, rt, planner=planner)
        if len(rt._pred_cache) >= self._PRED_CACHE_MAX:
            # one pass: purge version-stale entries (dead weight that can
            # never hit again), and only if that freed nothing evict the
            # LRU head.  The old two-step (purge loop THEN an
            # unconditional `while >= MAX` pop) re-checked capacity after
            # the purge and popped the oldest LIVE entry even when the
            # purge had already made room — evicting a just-refreshed hot
            # entry on insertion at exactly-full capacity.
            stale = [k for k, (v, *_rest) in rt._pred_cache.items()
                     if v != version]
            for stale_key in stale:
                del rt._pred_cache[stale_key]
            if not stale:
                rt._pred_cache.pop(next(iter(rt._pred_cache)))
        rt._pred_cache[key] = (version, cp,
                               planner.winner_for(cp.key, version))
        return cp

    def plan(self, patterns: Sequence,
             runtime: Optional[PackedRuntime] = None) -> QueryPlan:
        """Compile each request's predicate and coalesce identical
        predicates into one plan entry each (the host planner half).

        Wave head: the ONLY point where executor feedback folds into the
        cost model (planner.absorb), so a plan is compiled against one
        frozen cost state and generation-stamped plans stay immutable —
        single-chip, pipelined (engine.plan_batch lands here) and sharded
        planning all share this cadence (DESIGN.md §11)."""
        rt = runtime if runtime is not None else self.runtime
        self.planner.absorb()
        return rt.plan([self.compile(p, rt) for p in patterns])

    def query(self, v_q: np.ndarray, pattern, k: int,
              ef_search: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (distances, global ids) among vectors whose sequence
        satisfies ``pattern`` — a CONTAINS pattern, predicate string, or
        ``Predicate`` AST.  Empty pattern == unconstrained ANN.
        Single-request special case of ``query_batch``."""
        return self.query_batch(
            np.asarray(v_q, dtype=np.float32)[None, :], [pattern], k,
            ef_search=ef_search)[0]

    def query_batch(self, queries: np.ndarray,
                    patterns: Sequence, k: int,
                    ef_search: int = 64
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Batched query path: compile+plan once per distinct predicate,
        then one segmented device sweep for all brute-forced candidate
        sets + one vmapped beam search per shared graph (+ residual
        verification loops for multi-segment LIKE).  Returns
        [(dists, ids)] per request.  Plans and executes against ONE
        runtime snapshot, so a mid-batch compaction swap cannot mix
        generations."""
        rt = self.snapshot()
        t0 = time.perf_counter()
        plan = self.plan(patterns, rt)
        rt.wave_times["plan_ms"] += (time.perf_counter() - t0) * 1e3
        return rt.execute(queries, plan, k, ef_search=ef_search)

    # ------------------------------------------------------------------ #
    # maintenance (paper §5)
    # ------------------------------------------------------------------ #

    def insert(self, vector: np.ndarray, sequence: Sequence,
               attributes: Optional[Dict] = None) -> int:
        """Online insert: extend automaton; patch base indexes of affected
        states.  New states index only the new ID (their V starts at {i});
        clones rebuild their base against the current best successor —
        correctness over size-optimality, as in the paper's online update.

        Write path (DESIGN.md §4): the vector lands in the growable table
        (amortized O(d) append — no O(N) concatenate) and the id is logged
        into the current generation's delta at exactly the states the
        affected-state logic patches, so the frozen ``PackedRuntime`` —
        including its device-resident arrays — survives untouched.
        Queries merge base ∪ delta; the re-flatten cost moves to the next
        compaction, triggered here once the delta crosses the configured
        threshold (or immediately on a raw→graph promotion, which the
        frozen generation cannot see)."""
        i = self.esam.num_sequences
        self.sequences.append(sequence)
        # the delta row's attributes ride the live list (the runtime
        # shares it); attribute leaves pick them up at compile time via
        # the post-freeze scan, so no per-state delta record is needed
        self.attributes.append(self._norm_attrs(attributes))
        self._vec_store.append(vector)
        view = self.vectors
        for si in self.state_index:
            if si is not None and si.kind == _HNSW:
                si.graph.vectors = view          # re-point at the live view
        rt = self._runtime
        delta = rt.delta if rt is not None else None
        if rt is not None:
            rt.vectors = view
        old_n = self.esam.num_states
        self.esam.add_sequence(sequence)
        self.esam.finalize()
        n = self.esam.num_states
        # new states (created by this sequence): fresh indexes.  They are
        # past the generation's state watermark, so the compiler answers
        # them from their live ESAM V sets — no delta record needed.
        self.inherit.extend([-1] * (n - old_n))
        self.state_index.extend([None] * (n - old_n))
        for u in range(old_n, n):
            vu = self.esam.state_ids(u)
            if len(vu) > 1:
                # clone: recompute inheritance against current successors
                self.inherit[u] = self._pick_inherit(u)
                self.state_index[u] = self._build_one(u)
                if (delta is not None
                        and self.state_index[u].kind == _HNSW):
                    # a graph born after the freeze: delete() must reach
                    # it, and compaction should fold it into service
                    delta.fresh_graph_states.add(u)
            else:
                self.state_index[u] = _StateIndex(
                    _RAW, raw_ids=np.asarray([i], dtype=np.int64))
        # affected old states: those whose V gained i
        for u in range(old_n):
            vu = self.esam.state_ids(u)
            if len(vu) == 0 or vu[-1] != i:
                continue
            h = self.inherit[u]
            if h != -1:
                vh = self.esam.state_ids(h)
                if len(vh) and vh[-1] == i:
                    continue  # coverage flows up the chain
            idx = self.state_index[u]
            if idx is None:
                self.state_index[u] = _StateIndex(
                    _RAW, raw_ids=np.asarray([i], dtype=np.int64))
            elif idx.kind == _RAW:
                idx.raw_ids = np.append(idx.raw_ids, i)
                if (not self.config.skip_build
                        or len(idx.raw_ids) >= 4 * self.config.T):
                    self.state_index[u] = self._promote(idx.raw_ids, u)
                    if delta is not None:
                        delta.fresh_graph_states.add(u)
            else:
                idx.graph.add(i)
                if delta is not None:
                    # keep the delete fan-out map fresh incrementally; a
                    # post-freeze graph (promotion/clone) is absent from
                    # graph_objs and handled via fresh_graph_states
                    m = rt._id_graph_states
                    if m is not None and u in rt.graph_objs:
                        m.setdefault(i, []).append(u)
            if delta is not None:
                delta.record(u, i)
        if delta is not None:
            delta.pending += 1
            delta.inserted.append(i)             # replication delta log
            delta.version += 1                   # invalidates cached plans
        if self.config.auto_compact:
            self.maybe_compact()
        return i

    def maybe_compact(self) -> bool:
        """Threshold / size-ratio compaction trigger: fold the delta once
        it holds max(compact_min_inserts, compact_ratio · |frozen base|)
        inserts, or immediately after a raw→graph promotion (the promoted
        graph is invisible to the frozen generation until folded)."""
        rt = self._runtime
        if rt is None:
            return False
        d = rt.delta
        if d.empty and not d.fresh_graph_states:
            return False
        threshold = max(self.config.compact_min_inserts,
                        int(self.config.compact_ratio * d.n_base))
        if d.fresh_graph_states or d.pending >= threshold:
            self.compact()
            return True
        return False

    def compact(self) -> PackedRuntime:
        """Fold the delta and GC tombstones into a fresh generation.

        Built off the read path: the current generation keeps serving
        while the new one flattens — readers holding a snapshot stay on a
        consistent (generation, delta) view — and the swap is one
        reference assignment.  Tombstone GC drops deleted ids from every
        raw base set and rebuilds (or demotes) graphs whose tombstone
        fraction crossed ``_GRAPH_GC_FRAC``; the ids stay in ``deleted``
        because the ESAM's V sets cannot shrink."""
        with self._compact_lock:
            if self.deleted:
                self._gc_tombstones()
            new_rt = self._build_runtime()
            self._runtime = new_rt
            self.n_compactions += 1
            return new_rt

    _GRAPH_GC_FRAC = 0.5

    def _gc_tombstones(self) -> None:
        gone = np.fromiter(self.deleted, dtype=np.int64)
        for u, idx in enumerate(self.state_index):
            if idx is None:
                continue
            if idx.kind == _RAW:
                if len(idx.raw_ids):
                    keep = ~np.isin(idx.raw_ids, gone)
                    if not keep.all():
                        idx.raw_ids = idx.raw_ids[keep]
            else:
                g = idx.graph
                dead = g._deleted & set(int(x) for x in g.ids)
                if len(dead) <= self._GRAPH_GC_FRAC * max(1, len(g.ids)):
                    continue
                live = np.asarray([x for x in g.ids if x not in dead],
                                  dtype=np.int64)
                if len(live) < max(1, self.config.T):
                    self.state_index[u] = _StateIndex(_RAW, raw_ids=live)
                else:
                    ng = HNSW(self.vectors, M=self.config.M,
                              ef_con=self.config.ef_con,
                              metric=self.config.metric,
                              seed=self.config.seed + u)
                    ng.build(live)
                    self.state_index[u] = _StateIndex(_HNSW, graph=ng)

    def maintenance_stats(self) -> Dict[str, int]:
        """Write-path accounting (generation / delta / compaction counters
        plus the growable-buffer copy trace — bench_churn's acceptance
        signals: builds == compactions, O(log n) reallocations) and the
        device-execution trace (DESIGN.md §3): kernel launch + retrace
        counters (``launch_*``) and per-class host→device traffic bytes
        (``traffic_*``) that the benchmark gate and the retrace-regression
        test read."""
        rt = self._runtime
        out = {
            "generation": rt.generation if rt is not None else -1,
            "delta_pending": rt.delta.pending if rt is not None else 0,
            "delta_version": rt.delta.version if rt is not None else 0,
            "runtime_builds": self.runtime_builds,
            "compactions": self.n_compactions,
            "vector_reallocations": self._vec_store.reallocations,
            "vector_bytes_copied": self._vec_store.bytes_copied,
            "deleted": len(self.deleted),
        }
        for key, val in ops.launch_stats().items():
            out[f"launch_{key}"] = val
        if rt is not None:
            for key, val in rt.traffic.items():
                out[f"traffic_{key}"] = val
            # SQ8 scan-path accounting (certified vs escalated vs
            # fell-back batches) and the per-wave wall-clock breakdown.
            # Launch time is trace+dispatch (device dispatch is async);
            # the merge wave absorbs the device sync.
            for key, val in rt.sq8_stats.items():
                out[f"sq8_{key}"] = val
            for key, val in rt.wave_times.items():
                out[f"time_{key}"] = val
        # adaptive-planner trace (DESIGN.md §11): estimates vs observed,
        # strategy switches, cache-replayed winners
        out.update(self.planner.stats())
        return out

    def _promote(self, raw_ids: np.ndarray, u: int) -> _StateIndex:
        """Raw -> HNSW promotion once a raw set outgrows 4*T (paper §5): the
        brute-force sweep over the set now costs more than a graph search,
        so rebuild it as a graph against the packed runtime."""
        g = HNSW(self.vectors, M=self.config.M, ef_con=self.config.ef_con,
                 metric=self.config.metric, seed=self.config.seed + u)
        g.build(raw_ids)
        for vid in self.deleted & set(int(x) for x in raw_ids):
            g.mark_deleted(vid)
        return _StateIndex(_HNSW, graph=g)

    def delete(self, vector_id: int) -> None:
        """Lazy deletion (paper §5): mark and filter at query time.  The
        tombstone is propagated into every per-state graph whose node set
        contains the ID (so graph searches skip it in-scan instead of
        returning it and crowding out live candidates before the
        query-level filter), into graphs promoted since the generation
        froze, and into the device-resident mask.  Physical removal
        happens at the next compaction's tombstone GC."""
        vid = int(vector_id)
        self.deleted.add(vid)
        rt = self.runtime
        for u in rt.graph_states_of(vid):
            rt.graph_objs[u].mark_deleted(vid)
        for u in rt.delta.fresh_graph_states:
            idx = self.state_index[u]
            if (idx is not None and idx.kind == _HNSW
                    and vid in idx.graph.ids):
                idx.graph.mark_deleted(vid)
        rt.mark_deleted(vid)

    # ------------------------------------------------------------------ #
    # accounting / serialization
    # ------------------------------------------------------------------ #

    def size_entries(self) -> int:
        """Paper's index-size metric: stored ID entries + graph edge slots +
        automaton states/transitions."""
        s = self.esam.num_states + self.esam.num_transitions
        for idx in self.state_index:
            if idx is not None:
                s += idx.size_entries
        return s

    def stats(self) -> Dict[str, int]:
        n_raw = sum(1 for i in self.state_index
                    if i is not None and i.kind == _RAW)
        n_hnsw = sum(1 for i in self.state_index
                     if i is not None and i.kind == _HNSW)
        return {
            "states": self.esam.num_states,
            "transitions": self.esam.num_transitions,
            "total_id_entries": self.esam.total_id_entries(),
            "raw_states": n_raw,
            "hnsw_states": n_hnsw,
            "size_entries": self.size_entries(),
            "total_symbols": self.esam.total_symbols,
        }

    def save(self, path: str, extra_meta: Optional[Dict] = None) -> None:
        from ..distributed.checkpoint import save_vectormaton
        save_vectormaton(self, path, extra_meta=extra_meta)

    @classmethod
    def load(cls, path: str, config: Optional[VectorMatonConfig] = None,
             device: str = "cuda") -> "VectorMaton":
        """Restore a checkpoint; ``config`` supplies what the checkpoint
        does not record (backend, accum, plan mode), ``device`` where the
        torch backend runs."""
        from ..distributed.checkpoint import load_vectormaton
        return load_vectormaton(cls, path, config=config, device=device)

"""Pattern-constrained retrieval serving engine.

Port of ``src/repro/serve/engine.py`` (``Request``, ``Response``,
``WavePlan``, ``WavePending``, ``RetrievalEngine``) over the port's
index.  The engine runs where its ``VectorMatonConfig`` says —
``device="cuda"`` by default, which raises without a card.  Sharded
serving (``mesh``) waits for the sharded executor (ROADMAP Queue 1
item 7), and ``embed_texts`` for the LM stack (item 10).

Request flow (DESIGN.md §3):
    planner: predicate compile + automaton walks per request (µs-scale
       host work), identical predicates coalesced into one plan entry
    -> device-resident executor: ONE descriptor-driven segmented
       distance+top-k launch for all brute-forced candidate sets + ONE
       fused beam launch per graph size bucket + a device-side merge;
       residual verification loops for multi-segment LIKE stay on host.
       ``maintenance_stats`` exposes the launch counters and per-class
       host→device traffic the serving tier watches.

Requests accept predicate strings — ``"ab AND NOT (cd OR LIKE 'a%b_')"``
— as well as plain CONTAINS patterns (parsed in core/predicate.py).

Writes are first-class (DESIGN.md §4): ``insert`` lands in the index's
delta runtime — an O(d) vector append plus automaton patch, never a
runtime rebuild — and compaction folds the delta into a fresh generation
behind the readers (``serve_batch`` snapshots one generation per wave, so
an insert-triggered swap never splits a batch across generations).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.vectormaton import VectorMaton, VectorMatonConfig


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch has no sharded executor yet: serving over a mesh "
            "waits for ROADMAP Queue 1 item 7 "
            "(distributed/sharded_search.py)")


@dataclass
class Request:
    vector: np.ndarray
    pattern: str        # CONTAINS pattern or boolean predicate string,
                        # e.g. "ab AND NOT (cd OR LIKE 'a%b_')"
    k: int = 10
    ef_search: int = 64
    tenant: str = "default"   # admission namespace (ContinuousBatcher
                              # weighted deficit-round-robin, DESIGN.md §7)


@dataclass
class Response:
    ids: np.ndarray
    distances: np.ndarray
    latency_s: float    # batched serving: wall time of the request's wave
                        # (every request in a batch waits for the batch)


@dataclass
class WavePlan:
    """Fully-resolved, generation-stamped launch-ready wave: the output
    of the host planning stage (DESIGN.md §7).  Carries the runtime
    snapshot it was compiled against — dispatching it after the runtime
    moved (insert/compaction) raises the staleness ValueError, and the
    pipeline replans instead of locking writers out."""
    queries: np.ndarray
    patterns: List
    k: int
    ef_search: int
    rt: object          # PackedRuntime snapshot
    plan: object        # QueryPlan (generation/delta-version stamped)
    staged: Optional[object] = None   # StagingSlot (double-buffered upload)


@dataclass
class WavePending:
    """A dispatched wave: the in-flight device work + the WavePlan that
    produced it.  ``RetrievalEngine.fetch_batch`` resolves it to
    [(dists, ids)] — the only point that blocks on the device."""
    wave: WavePlan
    inner: object       # PendingExecution
    sharded: bool = False


class RetrievalEngine:
    """Single-device serving through the packed planner/executor.
    ``mesh`` (distributed serving, DESIGN.md §5) is not ported yet and
    raises ``NotImplementedError``."""

    def __init__(self, vectors: np.ndarray, sequences: Sequence[str],
                 config: Optional[VectorMatonConfig] = None,
                 workers: int = 1, mesh=None, shard_axis: str = "data",
                 attributes=None):
        _no_mesh(mesh)
        self.index = VectorMaton(vectors, sequences, config,
                                 workers=workers, attributes=attributes)
        self.mesh = mesh
        self.shard_axis = shard_axis
        # Serializes host-state mutation: planning (snapshot + predicate
        # compile + pred-cache), dispatch (launch bookkeeping, traffic
        # counters) and writes.  RLock so the synchronous public API can
        # compose the stages under one acquisition.  fetch_batch — the
        # device sync — runs OUTSIDE the lock: wave N's fetch must not
        # block wave N+1's planning (DESIGN.md §7).
        self._lock = threading.RLock()
        # live pipeline observability, merged into maintenance_stats();
        # written by serve.pipeline.PipelinedExecutor / ContinuousBatcher
        self.pipeline_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------ #
    # pipeline stage API (DESIGN.md §7): plan -> dispatch -> fetch
    # ------------------------------------------------------------------ #
    def plan_batch(self, queries: np.ndarray, patterns: Sequence, k: int,
                   ef_search: int = 64) -> WavePlan:
        """Host planning stage: snapshot one runtime generation, compile
        every predicate (pred-cache), coalesce into a QueryPlan.  Pure
        host work — safe on a background thread under the engine lock.
        Lands on ``VectorMaton.plan``, the wave head where pending
        executor feedback folds into the adaptive planner's cost model
        (DESIGN.md §11) — so cost state is frozen per wave and a
        dispatched plan is never re-decided mid-flight."""
        with self._lock:
            rt = self.index.snapshot()
            t0 = time.perf_counter()
            plan = self.index.plan(patterns, rt)
            rt.wave_times["plan_ms"] += (time.perf_counter() - t0) * 1e3
        return WavePlan(
            queries=np.ascontiguousarray(queries, dtype=np.float32),
            patterns=list(patterns), k=k, ef_search=ef_search,
            rt=rt, plan=plan)

    def dispatch_batch(self, wave: WavePlan) -> WavePending:
        """Device dispatch stage: launch the wave's kernels without
        syncing on results.  Raises the staleness ``ValueError`` if the
        runtime moved since ``plan_batch`` (insert bumped the delta
        version, compaction swapped the generation) — the pipeline
        replans; it never locks writers out.  A pinned staging slot
        uploads asynchronously and is guarded until that copy is done,
        on the error path too."""
        with self._lock:
            slot = wave.staged
            if slot is None:
                q = wave.queries
            else:
                n = len(wave.queries)
                q = slot.tensor(n) if slot.pinned else slot.view(n)
            try:
                inner = wave.rt.dispatch(q, wave.plan, wave.k,
                                         ef_search=wave.ef_search)
            finally:
                if slot is not None:
                    slot.guard()
            return WavePending(wave=wave, inner=inner)

    def fetch_batch(self, pending: WavePending
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Completion stage: wait for the wave's own device work and
        assemble per-request results.  Deliberately lock-free — the
        tensors it touches belong to the dispatched wave alone, and
        blocking here must overlap the next wave's planning.  The wave's
        staging slot is released on every path out."""
        try:
            return pending.wave.rt.fetch(pending.inner)
        finally:
            if pending.wave.staged is not None:
                pending.wave.staged.release()

    # ------------------------------------------------------------------ #
    def query_batch(self, queries: np.ndarray, patterns: Sequence,
                    k: int, ef_search: int = 64
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The engine's execution entry point: plans and executes against
        ONE runtime snapshot, so an insert-triggered compaction swap
        never splits a batch.  The synchronous composition of the three
        pipeline stages, with the plan->dispatch pair under one lock
        acquisition so a concurrent writer can never strand this batch
        with a stale plan."""
        with self._lock:
            wave = self.plan_batch(queries, patterns, k,
                                   ef_search=ef_search)
            pending = self.dispatch_batch(wave)
        return self.fetch_batch(pending)

    def serve(self, req: Request) -> Response:
        t0 = time.perf_counter()
        d, i = self.query_batch(
            np.asarray(req.vector, np.float32)[None, :], [req.pattern],
            req.k, ef_search=req.ef_search)[0]
        return Response(ids=i, distances=d,
                        latency_s=time.perf_counter() - t0)

    def serve_batch(self, reqs: Sequence[Request]) -> List[Response]:
        """Cross-request batched execution: requests are grouped by
        (k, ef_search) and handed to ``query_batch``, whose planner
        coalesces same-predicate requests so compilation happens once per
        distinct predicate and the distance work runs as one batched
        device sweep instead of one call per request."""
        out: List[Optional[Response]] = [None] * len(reqs)
        groups: Dict[Tuple[int, int], List[int]] = {}
        for idx, r in enumerate(reqs):
            groups.setdefault((r.k, r.ef_search), []).append(idx)
        for (k, ef), idxs in groups.items():
            t0 = time.perf_counter()
            queries = np.stack([np.asarray(reqs[i].vector, np.float32)
                                for i in idxs])
            patterns = [reqs[i].pattern for i in idxs]
            results = self.query_batch(queries, patterns, k, ef_search=ef)
            dt = time.perf_counter() - t0
            for i, (d, ids) in zip(idxs, results):
                out[i] = Response(ids=ids, distances=d, latency_s=dt)
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------ #
    def insert(self, vector: np.ndarray, sequence: str,
               attributes: Optional[dict] = None) -> int:
        """Delta-runtime write: amortized O(d) append, auto-compacted per
        the index config's threshold (VectorMaton.maybe_compact).  Bumps
        the delta version, so any in-flight WavePlan becomes stale and
        the pipeline replans it — the lock only serializes the write
        itself against planning/dispatch."""
        with self._lock:
            return self.index.insert(vector, sequence,
                                     attributes=attributes)

    def delete(self, vector_id: int) -> None:
        with self._lock:
            self.index.delete(vector_id)

    def compact(self) -> None:
        """Force-fold the write delta into a fresh generation (the
        auto-compaction trigger normally handles this)."""
        with self._lock:
            self.index.compact()

    def maintenance_stats(self):
        """Generation / delta / compaction counters, plus the live
        pipeline counters (pipeline_depth, device_idle_ms, planner-queue
        wait, per-tenant depth/latency) when a pipelined batcher is
        attached (DESIGN.md §7)."""
        with self._lock:
            stats = self.index.maintenance_stats()
            stats.update(self.pipeline_stats)
        return stats

    def replication_token(self) -> Tuple[int, int]:
        """(generation, delta_version) of the live runtime — the write-
        path stamps that replication delta-log records carry (DESIGN.md
        §10): followers check them for monotonicity, and the router's
        staleness policy counts versions against them."""
        with self._lock:
            rt = self.index._runtime
            return ((rt.generation, rt.delta.version) if rt is not None
                    else (-1, -1))

    def checkpoint(self, path: str,
                   extra_meta: Optional[Dict] = None) -> None:
        with self._lock:
            self.index.save(path, extra_meta=extra_meta)

    @classmethod
    def restore(cls, path: str, mesh=None, shard_axis: str = "data",
                config: Optional[VectorMatonConfig] = None,
                device: str = "cuda") -> "RetrievalEngine":
        """Restore a checkpointed engine (written by either package) on
        ``device``; ``config`` supplies what the checkpoint does not
        record (backend, accum, plan mode)."""
        _no_mesh(mesh)
        self = cls.__new__(cls)
        self.index = VectorMaton.load(path, config=config, device=device)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self._lock = threading.RLock()
        self.pipeline_stats = {}
        return self


__all__ = ["Request", "Response", "WavePlan", "WavePending",
           "RetrievalEngine"]

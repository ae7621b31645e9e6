"""Continuous-batching request scheduler (beyond-paper serving substrate).

Port of ``src/repro/serve/batching.py`` (``ContinuousBatcher``,
``DrainTimeout``, ``RequestTimeout``) over the port's engine, which runs
on the card by default.  The pipeline barrier a write takes is bounded
by ``request_timeout_s`` here: a wedged pipeline raises instead of
hanging the writer.

Pattern-constrained queries have wildly variable cost (chain length ×
state sizes × boolean structure).  A fixed batch ties P50 latency to the
slowest request; the scheduler below keeps a bounded in-flight window,
admits by arrival order with a cost model (the predicate compiler's
selectivity estimate from |V_state| — available *before* any distance
work), and coalesces same-predicate requests so compilation and the fused
brute-force kernel run once per predicate per wave.  Requests carry
predicate strings (``"ab AND NOT LIKE 'c%d'"``) or plain patterns alike.

This is the host-side analogue of LLM continuous batching: the automaton
walk is the "prefill" (µs, host), the distance work is the "decode"
(device), and waves are packed to the device-batch budget.

Two extensions on top (DESIGN.md §7):

* **Tenants.**  Every request carries a tenant id.  With a single
  tenant, admission is the strict-FIFO budget walk below, unchanged.
  With several, waves are packed by *weighted deficit round-robin*: each
  tenant keeps a deficit counter, each admission round credits it
  ``weight · quantum`` and admits that tenant's FIFO head while the
  deficit covers its cost — one bursting tenant can saturate its own
  share but never the whole wave.  ``max_defer`` force-admission still
  backstops starvation, and per-tenant depth/served/p50/p99 surface in
  ``maintenance_stats``.

* **Pipelined execution.**  ``pipeline=True`` (default) streams waves
  through ``serve.pipeline.PipelinedExecutor``: wave N+1 is planned and
  its query matrix staged while wave N's launches execute.  Writes —
  ``submit_insert`` / ``submit_delete`` / ``submit_compact`` — are
  pipeline *barriers*: every in-flight wave is fetched before the write
  applies, and any wave planned-but-not-dispatched across a write is
  rejected by the generation/delta-version stamp and replanned.  That,
  plus identical wave formation, makes the pipelined stream bit-exact
  with ``pipeline=False`` (the synchronous oracle, kept as a toggle).
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Deque, List, Optional, Sequence, Tuple

import numpy as np

from .engine import Request, Response, RetrievalEngine


class DrainTimeout(RuntimeError):
    """``drain`` exceeded its ``max_waves``/``deadline_s`` bound (or
    made no admission progress) with work still queued — surfaced
    instead of spinning forever on a request that can never be
    admitted under the configured budget."""


class RequestTimeout(RuntimeError):
    """A dispatched wave did not deliver within the batcher's
    per-request deadline (``request_timeout_s``) — the pipeline wedged
    or a kernel hung.  Raised to the submitter instead of blocking it
    forever; the affected requests are counted as ``dropped`` in
    ``tenant_stats`` so the loss is observable.  ``tickets`` carries the
    timed-out submission ids."""

    def __init__(self, msg: str, tickets=()):
        super().__init__(msg)
        self.tickets = list(tickets)


@dataclass(order=True)
class _Queued:
    sort_key: Tuple
    seq: int = field(compare=False)
    request: Request = field(compare=False)
    key: object = field(compare=False)       # canonical predicate key
    cost: int = field(compare=False)
    t_arrival: float = field(compare=False)


class _TenantState:
    """Per-tenant admission + latency bookkeeping."""

    __slots__ = ("deficit", "served", "dropped", "latencies")

    def __init__(self) -> None:
        self.deficit = 0.0
        self.served = 0
        self.dropped = 0           # requests lost to RequestTimeout
        self.latencies: Deque[float] = deque(maxlen=512)


class ContinuousBatcher:
    """Admission + wave scheduling over a RetrievalEngine.

    ``budget``: max Σ|V_p| distance rows per wave (device batch budget).
    ``max_wave``: max requests per wave.
    Fairness (single tenant): strict FIFO — admission stops at the first
    request that would blow the budget, so a passed-over request is the
    very next wave's head and admits unconditionally (no starvation by
    construction).  ``max_defer`` is a defensive backstop: it can only
    bind if admission order ever stops being pure arrival order.
    Fairness (multi-tenant): weighted deficit round-robin across tenant
    FIFO queues under the same global budget; ``tenant_weights`` maps
    tenant id -> relative share (default 1.0).

    Writes interleave with reads (DESIGN.md §4): ``submit_insert`` /
    ``submit_delete`` / ``submit_compact`` enqueue records, and each
    wave applies pending writes at its head — after flushing the
    pipeline, so a write is a barrier, never a torn read.  Every insert
    is an O(d) delta append; if it trips the compaction threshold the
    generation swap happens between waves, and any wave planned across
    it is staleness-rejected and replanned.

    ``submit``/``submit_insert``/``run_wave``/``drain`` are thread-safe:
    queue state lives behind the batcher's leaf lock, write application
    and planning behind the engine's lock (always acquired in that
    order, never nested the other way).
    """

    def __init__(self, engine: RetrievalEngine, budget: int = 200_000,
                 max_wave: int = 64, max_defer: int = 4,
                 pipeline: bool = True,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 request_timeout_s: float = 120.0):
        self.engine = engine
        self.budget = budget
        self.max_wave = max_wave
        self.max_defer = max_defer
        self.pipeline = pipeline
        # per-request delivery deadline: how long a submitter waits on a
        # dispatched wave before the drop is recorded and RequestTimeout
        # raised (was a hard-coded 120 s wait)
        self.request_timeout_s = request_timeout_s
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        self._queue: List[_Queued] = []
        # Σ t_arrival over the queue: admission reads a wave's queue wait
        # from it with one clock reading, not a pass over the wave
        self._arrivals = 0.0
        self._seq = 0
        self._deferred: Dict[int, int] = {}
        self._writes: Deque[Tuple] = deque()
        self._write_seq = 0
        # write ticket -> result id.  Bounded FIFO: a long-lived serving
        # process applies unbounded writes, so callers must read their
        # ticket within _WRITE_RESULTS_MAX subsequent writes.
        self.write_results: Dict[int, int] = {}
        self.writes_applied = 0
        self._lock = threading.Lock()        # leaf: queues + tickets only
        self._tenants: Dict[str, _TenantState] = {}
        self._pipe = None                    # lazy PipelinedExecutor
        self._wave_counter = 0
        # test/instrumentation hook: called with the wave-job index right
        # before that wave executes (sync) / dispatches (pipelined) — the
        # same observable point, so an injected write forces a replan in
        # the pipeline and a fresh plan in the oracle, identically
        self.on_wave_start: Optional[Callable[[int], None]] = None

    _WRITE_RESULTS_MAX = 4096

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> int:
        """Returns a ticket id.  The admission cost is the predicate
        compiler's selectivity estimate (Σ|V_state| over the compiled
        sources) — boolean predicates are priced by the candidate rows
        their strategies will actually touch."""
        t0 = time.perf_counter()
        index = self.engine.index
        with self.engine._lock:              # pred-cache is shared state
            c0 = time.perf_counter()
            cp = index.compile(req.pattern)
        t = time.perf_counter()              # compile's end and arrival
        with self._lock:
            q = _Queued(sort_key=(t, self._seq), seq=self._seq,
                        request=req, key=cp.key, cost=cp.est, t_arrival=t)
            heapq.heappush(self._queue, q)
            self._arrivals += t
            self._seq += 1
            self._tenants.setdefault(req.tenant, _TenantState())
        index.trace.request(t0, c0, t, time.perf_counter(), q.seq)
        return q.seq

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------------ #
    def submit_insert(self, vector: np.ndarray, sequence: Sequence,
                      attributes: Optional[dict] = None) -> int:
        """Enqueue a write; applied at the head of the next wave (after a
        pipeline flush).  Returns a write ticket — once the wave that
        applies it has run, the assigned vector id is available in
        ``write_results[ticket]``."""
        with self._lock:
            t = self._write_seq
            self._write_seq += 1
            self._writes.append(("insert", t, vector, sequence,
                                 attributes))
            return t

    def submit_delete(self, vector_id: int) -> int:
        """Enqueue a tombstone; ``write_results[ticket]`` echoes the id
        once applied."""
        with self._lock:
            t = self._write_seq
            self._write_seq += 1
            self._writes.append(("delete", t, vector_id))
            return t

    def submit_compact(self) -> int:
        """Enqueue a forced compaction (generation fold);
        ``write_results[ticket]`` holds the new generation number."""
        with self._lock:
            t = self._write_seq
            self._write_seq += 1
            self._writes.append(("compact", t))
            return t

    def writes_pending(self) -> int:
        with self._lock:
            return len(self._writes)

    def _apply_writes(self) -> List[int]:
        """Drain pending writes into the delta runtime (pre-wave).  A
        barrier point in pipelined mode: the caller flushed all in-flight
        waves first, so no dispatched plan can straddle these ops."""
        with self._lock:
            ops = list(self._writes)
            self._writes.clear()
        if not ops:
            return []
        ids: List[int] = []
        for op in ops:
            if op[0] == "insert":
                _, t, v, s = op[:4]
                attrs = op[4] if len(op) > 4 else None
                res = self.engine.insert(v, s, attributes=attrs)
                ids.append(res)
            elif op[0] == "delete":
                _, t, res = op
                self.engine.delete(res)
            else:                                        # compact
                _, t = op
                self.engine.compact()
                res = self.engine.index.maintenance_stats()["generation"]
            with self._lock:
                self.write_results[t] = res
                while len(self.write_results) > self._WRITE_RESULTS_MAX:
                    self.write_results.pop(next(iter(self.write_results)))
        with self._lock:
            self.writes_applied += len(ops)
        return ids

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def next_wave(self) -> List[_Queued]:
        """Admit under the cost budget; force-admit starved items.

        Single tenant — strict FIFO: admission stops at the first
        request that would blow the budget; only that request is
        *passed over* (and only its deferral counter ticks) — the rest
        of the queue was never examined, so it is not deferred.

        Multi-tenant — weighted deficit round-robin (DRR): tenants take
        turns; each visit credits ``weight · quantum`` of deficit and
        admits that tenant's FIFO heads while the deficit covers their
        cost, under the same global budget.  The globally-oldest request
        still opens the wave unconditionally, and a budget-blocked head
        ticks its deferral exactly once per wave, so the single-tenant
        invariants (head always admits; ≤1 new deferral per wave) carry
        over.

        The wave's queue wait, each request's arrival to this admission,
        goes to the index's ``batcher.queue_wait`` total."""
        t = time.perf_counter()
        with self._lock:
            if not self._queue:
                return []
            before = self._arrivals
            tenants = {q.request.tenant for q in self._queue}
            if len(tenants) <= 1:
                wave = self._next_wave_fifo()
            else:
                wave = self._next_wave_drr()
            if not self._queue:
                self._arrivals = 0.0        # drop the sum's rounding
            waited = len(wave) * t - (before - self._arrivals)
        self.engine.index.trace.add("batcher.queue_wait", len(wave), waited)
        return wave

    def _next_wave_fifo(self) -> List[_Queued]:
        wave: List[_Queued] = []
        spent = 0
        while self._queue and len(wave) < self.max_wave:
            q = self._queue[0]                   # peek: FIFO head
            force = self._deferred.get(q.seq, 0) >= self.max_defer
            if wave and not force and spent + q.cost > self.budget:
                self._deferred[q.seq] = self._deferred.get(q.seq, 0) + 1
                break
            heapq.heappop(self._queue)
            self._arrivals -= q.t_arrival
            self._deferred.pop(q.seq, None)      # admitted: counter done
            wave.append(q)
            spent += q.cost
        return wave

    def _next_wave_drr(self) -> List[_Queued]:
        # per-tenant FIFO views, tenants ordered by their head's arrival
        per: "OrderedDict[str, Deque[_Queued]]" = OrderedDict()
        for q in sorted(self._queue):
            per.setdefault(q.request.tenant, deque()).append(q)
        active = list(per)
        wsum = sum(float(self.tenant_weights.get(t, 1.0))
                   for t in active) or 1.0
        quantum = max(1.0, self.budget / max(1, len(active)))
        # weighted share of the wave's REQUEST slots (so a flood tenant
        # cannot fill max_wave before others get a turn) on top of the
        # deficit share of the wave's COST budget
        slots = {t: max(1, int(self.max_wave
                               * float(self.tenant_weights.get(t, 1.0))
                               / wsum))
                 for t in active}
        taken = {t: 0 for t in active}
        wave: List[_Queued] = []
        spent = 0
        budget_blocked = False
        # the globally-oldest request opens the wave unconditionally —
        # same head rule as the FIFO walk, so one giant request can
        # never deadlock admission
        rounds = 0
        while (len(wave) < self.max_wave and not budget_blocked
               and any(per.values()) and rounds < 64):
            progress = False
            for tname, fifo in per.items():
                if not fifo or len(wave) >= self.max_wave:
                    continue
                ts = self._tenants.setdefault(tname, _TenantState())
                w = float(self.tenant_weights.get(tname, 1.0))
                ts.deficit = min(ts.deficit + quantum * w, 8 * quantum)
                while (fifo and len(wave) < self.max_wave
                       and taken[tname] < slots[tname]):
                    q = fifo[0]
                    force = (self._deferred.get(q.seq, 0)
                             >= self.max_defer)
                    if wave and not force and spent + q.cost > self.budget:
                        self._deferred[q.seq] = (
                            self._deferred.get(q.seq, 0) + 1)
                        budget_blocked = True
                        break
                    if wave and not force and q.cost > ts.deficit:
                        break                    # out of share this round
                    fifo.popleft()
                    self._deferred.pop(q.seq, None)
                    wave.append(q)
                    spent += q.cost
                    ts.deficit = max(0.0, ts.deficit - q.cost)
                    taken[tname] += 1
                    progress = True
                if budget_blocked:
                    break
            rounds += 1
            if not progress:
                break               # shares exhausted for this wave
        if not budget_blocked and len(wave) < self.max_wave:
            # work-conserving fill: spare slots go FIFO-globally once
            # every tenant had its weighted turn (budget still binds)
            for q in sorted(q for fifo in per.values() for q in fifo):
                if len(wave) >= self.max_wave:
                    break
                force = self._deferred.get(q.seq, 0) >= self.max_defer
                if wave and not force and spent + q.cost > self.budget:
                    self._deferred[q.seq] = (
                        self._deferred.get(q.seq, 0) + 1)
                    break
                self._deferred.pop(q.seq, None)
                wave.append(q)
                spent += q.cost
        admitted = {q.seq for q in wave}
        self._queue = [q for q in self._queue if q.seq not in admitted]
        heapq.heapify(self._queue)
        self._arrivals -= sum(q.t_arrival for q in wave)
        return wave

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def _pipeline_executor(self):
        if self._pipe is None:
            from .pipeline import PipelinedExecutor
            self._pipe = PipelinedExecutor(self.engine)
        return self._pipe

    def _record(self, q: _Queued, resp: Response) -> None:
        ts = self._tenants.setdefault(q.request.tenant, _TenantState())
        ts.served += 1
        ts.latencies.append(resp.latency_s)

    def _wave_groups(self, wave: List[_Queued]):
        groups: Dict[Tuple[int, int], List[_Queued]] = {}
        for q in wave:
            groups.setdefault((q.request.k, q.request.ef_search),
                              []).append(q)
        return groups

    def run_wave(self) -> Dict[int, Response]:
        """Execute one wave through the batched planner/executor: the
        wave's requests (grouped by k/ef) hit the engine's stage API,
        whose planner coalesces same-state requests into shared plan
        entries (and which routes through the sharded executor when the
        engine has a mesh attached).  ``run_wave`` is a synchronous
        boundary — it returns the wave's responses — so overlap across
        waves comes from ``drain``/``run_stream``, which keep multiple
        waves in flight."""
        out: Dict[int, Response] = {}
        self._submit_wave(out, collect=True)
        return out

    def _submit_wave(self, out: Dict[int, Response], collect: bool,
                     jobs: Optional[List] = None) -> int:
        """Apply writes (barrier), form one wave, execute or enqueue it.
        Returns the number of admitted requests."""
        trace = self.engine.index.trace
        with trace.span("batcher.wave", wave=self._wave_counter):
            if self.writes_pending():
                if self._pipe is not None:
                    self._pipe.barrier(timeout=self.request_timeout_s)
                if jobs:
                    self._collect_jobs(jobs, out)
                self._apply_writes()
            with trace.span("batcher.admit"):
                wave = self.next_wave()
            if not wave:
                return 0
            for (k, ef), items in self._wave_groups(wave).items():
                queries = np.stack([np.asarray(q.request.vector, np.float32)
                                    for q in items])
                patterns = [q.request.pattern for q in items]
                idx = self._wave_counter
                self._wave_counter += 1
                if self.pipeline:
                    hook = (None if self.on_wave_start is None else
                            (lambda i=idx: self.on_wave_start(i)))
                    job = self._pipeline_executor().submit(
                        queries, patterns, k, ef_search=ef,
                        pre_dispatch=hook)
                    if jobs is not None and not collect:
                        jobs.append((job, items))
                    else:
                        self._collect_jobs([(job, items)], out)
                else:
                    if self.on_wave_start is not None:
                        self.on_wave_start(idx)
                    results = self.engine.query_batch(queries, patterns, k,
                                                      ef_search=ef)
                    self._respond(items, results, out)
            return len(wave)

    def _respond(self, items: List[_Queued], results,
                 out: Dict[int, Response]) -> None:
        """The wave's ``Response``s (latency to now) and tenant records."""
        with self.engine.index.trace.span("batcher.respond"):
            t1 = time.perf_counter()
            for q, (d, i) in zip(items, results):
                resp = Response(ids=i, distances=d,
                                latency_s=t1 - q.t_arrival)
                out[q.seq] = resp
                self._record(q, resp)
                self._deferred.pop(q.seq, None)

    def _collect_jobs(self, jobs: List, out: Dict[int, Response]) -> None:
        trace = self.engine.index.trace
        for job, items in jobs:
            try:
                with trace.span("batcher.wait"):
                    results = job.wait(timeout=self.request_timeout_s)
            except TimeoutError:
                # deadline blown: record the loss per tenant and surface
                # a typed error instead of hanging the submitter on a
                # wedged pipeline
                with self._lock:
                    for q in items:
                        self._tenants.setdefault(
                            q.request.tenant, _TenantState()).dropped += 1
                jobs.clear()
                raise RequestTimeout(
                    f"wave of {len(items)} request(s) undelivered after "
                    f"{self.request_timeout_s:.1f}s "
                    f"(request_timeout_s deadline)",
                    tickets=[q.seq for q in items]) from None
            self._respond(items, results, out)
        jobs.clear()

    def drain(self, max_waves: Optional[int] = None,
              deadline_s: Optional[float] = None) -> Dict[int, Response]:
        """Run waves until the queue and write log are empty.

        ``max_waves`` / ``deadline_s`` bound the loop: exceeding either
        with work still pending raises ``DrainTimeout`` instead of
        spinning — as does a wave that admits nothing while requests
        remain (a request that can never be admitted under the budget).

        In pipelined mode waves are kept in flight back-to-back: wave
        N+1 is planned and dispatched while wave N executes; only write
        barriers and the final flush synchronize."""
        out: Dict[int, Response] = {}
        jobs: List = []
        waves = 0
        t0 = time.perf_counter()
        while True:
            if not (self.pending() or self.writes_pending() or jobs):
                break
            if self.pending() or self.writes_pending():
                if max_waves is not None and waves >= max_waves:
                    self._collect_jobs(jobs, out)
                    raise DrainTimeout(
                        f"drain: {self.pending()} request(s) + "
                        f"{self.writes_pending()} write(s) still pending "
                        f"after {waves} waves (max_waves={max_waves})")
                if (deadline_s is not None
                        and time.perf_counter() - t0 > deadline_s):
                    self._collect_jobs(jobs, out)
                    raise DrainTimeout(
                        f"drain: work still pending after "
                        f"{deadline_s:.3f}s deadline")
            admitted = self._submit_wave(out, collect=False, jobs=jobs)
            if admitted or self.writes_pending():
                waves += 1
                # bound planner run-ahead: never hold more than two
                # un-fetched waves (one in flight + one planned)
                while len(jobs) > 2:
                    self._collect_jobs(jobs[:1], out)
                    del jobs[:1]
                continue
            if jobs:
                self._collect_jobs(jobs, out)
                continue
            if self.pending():
                raise DrainTimeout(
                    f"drain: wave admitted nothing with "
                    f"{self.pending()} request(s) queued — cannot be "
                    f"admitted under budget={self.budget}, "
                    f"max_wave={self.max_wave}")
        self._collect_jobs(jobs, out)
        self._publish_tenant_stats()
        return out

    def close(self) -> None:
        """Flush and stop the pipeline threads (idempotent)."""
        if self._pipe is not None:
            self._pipe.close(timeout=self.request_timeout_s)
            self._pipe = None

    # ------------------------------------------------------------------ #
    # observability (DESIGN.md §7)
    # ------------------------------------------------------------------ #
    def _publish_tenant_stats(self) -> None:
        self.engine.pipeline_stats["tenants"] = self.tenant_stats()

    def tenant_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant queue depth / served count / latency percentiles
        over the last 512 responses."""
        with self._lock:
            depth: Dict[str, int] = {}
            for q in self._queue:
                depth[q.request.tenant] = depth.get(q.request.tenant,
                                                    0) + 1
            stats: Dict[str, Dict[str, float]] = {}
            for t, ts in self._tenants.items():
                lat = np.asarray(ts.latencies, dtype=np.float64)
                stats[t] = {
                    "depth": depth.get(t, 0),
                    "served": ts.served,
                    "dropped": ts.dropped,
                    "p50_ms": (float(np.percentile(lat, 50)) * 1e3
                               if len(lat) else 0.0),
                    "p99_ms": (float(np.percentile(lat, 99)) * 1e3
                               if len(lat) else 0.0),
                }
            return stats

    def maintenance_stats(self) -> Dict:
        """Engine maintenance counters + live pipeline counters
        (pipeline_depth, device_idle_ms, planner_wait_ms, replans) +
        per-tenant depth/served/p50/p99."""
        self._publish_tenant_stats()
        stats = self.engine.maintenance_stats()
        stats["queue_depth"] = self.pending()
        stats["writes_pending"] = self.writes_pending()
        return stats


__all__ = ["ContinuousBatcher", "DrainTimeout", "RequestTimeout"]

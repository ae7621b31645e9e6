"""Pipelined serving executor — overlap host planning with device
execution (DESIGN.md §7).

Port of ``src/repro/serve/pipeline.py`` (``WaveJob``,
``PipelinedExecutor``) over the port's engine.  JAX's fetch waits only
for the buffers it reads; a CUDA stream runs in order, so the port's
``fetch`` waits on the wave's own event (``core/packed.py``) and never
on the successor wave dispatched before it.  On a CUDA engine the
staging ring's slots are pinned and the wave's query upload is
asynchronous.

The synchronous loop costs ``plan + dispatch + device + fetch`` per wave
with the device idle during every host phase.  This module splits the
wave into the engine's three stages and runs them on a two-thread
pipeline:

    submit ─▶ [planner thread]  plan_batch + staging-ring copy
                   │      (bounded hand-off queue, depth 1)
                   ▼
              [executor thread] dispatch_batch   — async kernel launches
                   │      (in-flight window, 1 wave)
                   ▼
                              fetch_batch        — the ONLY device sync
                   │
                   ▼
              job.done set, results delivered in submit order

Wave N+1 is planned while wave N's kernels execute, and wave N's
device→host fetch happens only after wave N+1 has already been
dispatched — asynchronous CUDA launches keep the device fed while the
host merges wave N.

Exactness (the PR 3 staleness contract, not locks): every plan is
generation/delta-version stamped.  A write that lands between a wave's
plan and its dispatch bumps the version, dispatch raises the staleness
``ValueError``, and the executor REPLANS the wave against the live
runtime (counted in ``pipeline_replans``) — answers are always computed
against a consistent snapshot, never a torn one.  ``barrier()`` flushes
the pipeline (planner drained, all in-flight waves fetched); the
batcher wraps every write application in one, which is what makes the
pipelined stream bit-exact with the synchronous oracle.

Fallback to synchronous execution (``ContinuousBatcher(pipeline=False)``
or ``PipelinedExecutor.run_sync``) is kept as the parity oracle and for
cold starts where overlap cannot pay (first-shape compiles dominate).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class WaveJob:
    """One wave travelling through the pipeline.  ``wait()`` blocks the
    submitter until the fetch stage delivered (or an error surfaced)."""
    queries: np.ndarray
    patterns: List
    k: int
    ef_search: int
    index: int = -1                     # submission order (0-based)
    pre_dispatch: Optional[Callable[[], None]] = None
    results: Optional[List] = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> List:
        if not self.done.wait(timeout):
            raise TimeoutError("pipelined wave did not complete")
        if self.error is not None:
            raise self.error
        return self.results


class PipelinedExecutor:
    """Two threads, three stages, depth-1 hand-off — the smallest shape
    that fully hides host planning behind device execution.

    The planner thread owns ``plan_batch`` (predicate compile, pred
    cache, wave formation integers) and the staging-ring copy; the
    executor thread owns ``dispatch_batch`` (launches, under the engine
    lock, brief) and ``fetch_batch`` (device sync, outside the lock).
    The in-flight window is one wave: dispatch N+1, then fetch N, which
    waits on wave N's event only.
    Adaptive-planner feedback (DESIGN.md §11) needs no extra plumbing
    here: executor timings buffer in the planner and fold at the next
    ``plan_batch`` (the wave head), so the wave in flight and the wave
    being planned never share mutable cost state.

    Counters (merged into ``RetrievalEngine.maintenance_stats`` via
    ``engine.pipeline_stats``):

      * ``device_idle_ms``   — time the device spent with NO wave in
        flight between two consecutive dispatches (warm target ≈ 0);
      * ``planner_wait_ms``  — executor thread blocked waiting for the
        planner (positive = planning is the bottleneck);
      * ``pipeline_replans`` — waves replanned after a staleness reject;
      * ``pipeline_waves`` / ``pipeline_barriers`` / ``pipeline_depth``.
    """

    def __init__(self, engine, staging: bool = True) -> None:
        from .step import StagingRing
        self.engine = engine
        self._in: "queue.Queue[Optional[WaveJob]]" = queue.Queue()
        self._planned: "queue.Queue[Optional[Tuple[WaveJob, object]]]" = (
            queue.Queue(maxsize=1))
        cfg = engine.index.config
        # pinned slots exactly when the wave's upload goes to a card
        self._ring = (StagingRing(
            engine.index.vectors.shape[1],
            pin=(cfg.backend == "torch"
                 and torch.device(cfg.device).type == "cuda"))
            if staging else None)
        self._n_jobs = 0
        self._submitted = 0
        self._completed = 0
        self._closed = False
        self._cv = threading.Condition()
        self.stats: Dict[str, float] = {
            "pipeline_waves": 0, "pipeline_replans": 0,
            "pipeline_barriers": 0, "device_idle_ms": 0.0,
            "planner_wait_ms": 0.0, "pipeline_depth": 0,
        }
        self._device_free_since: Optional[float] = None
        self._inflight_n = 0
        self._planner = threading.Thread(
            target=self._plan_loop, name="repro_torch-planner",
            daemon=True)
        self._executor = threading.Thread(
            target=self._exec_loop, name="repro_torch-executor",
            daemon=True)
        self._planner.start()
        self._executor.start()

    # ------------------------------------------------------------------ #
    # submit / flush
    # ------------------------------------------------------------------ #
    def submit(self, queries: np.ndarray, patterns: Sequence, k: int,
               ef_search: int = 64,
               pre_dispatch: Optional[Callable[[], None]] = None
               ) -> WaveJob:
        if self._closed:
            raise RuntimeError("PipelinedExecutor is closed")
        job = WaveJob(queries=np.asarray(queries, np.float32),
                      patterns=list(patterns), k=k, ef_search=ef_search,
                      pre_dispatch=pre_dispatch)
        with self._cv:
            job.index = self._n_jobs
            self._n_jobs += 1
            self._submitted += 1
        self._in.put(job)
        return job

    def barrier(self, timeout: Optional[float] = None) -> None:
        """Pipeline barrier: block until every submitted wave has been
        planned, dispatched AND fetched.  Writes wrap themselves in one —
        after it returns, no in-flight plan can reference pre-write
        state, which is the §7 exactness argument.  ``timeout`` bounds
        the wait: a pipeline that does not drain in time raises
        ``TimeoutError`` instead of hanging the caller."""
        self.stats["pipeline_barriers"] += 1
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._completed == self._submitted,
                    timeout=timeout):
                raise TimeoutError(
                    f"pipeline barrier: {self._submitted - self._completed}"
                    f" wave(s) undelivered after {timeout:.1f}s")

    def run_sync(self, queries, patterns, k, ef_search: int = 64):
        """Synchronous oracle path: same engine, no overlap.  Kept so
        callers can A/B the pipeline under identical op streams."""
        return self.engine.query_batch(queries, patterns, k,
                                       ef_search=ef_search)

    def close(self, timeout: Optional[float] = None) -> None:
        if self._closed:
            return
        self.barrier(timeout=timeout)
        self._closed = True
        self._in.put(None)
        self._planner.join(timeout=10)
        self._executor.join(timeout=10)

    # ------------------------------------------------------------------ #
    # stage loops
    # ------------------------------------------------------------------ #
    def _plan_loop(self) -> None:
        while True:
            job = self._in.get()
            if job is None:
                self._planned.put(None)
                return
            try:
                wave = self.engine.plan_batch(job.queries, job.patterns,
                                              job.k,
                                              ef_search=job.ef_search)
                if self._ring is not None:
                    wave.staged = self._ring.acquire(job.queries,
                                                     timeout=60.0)
                self._planned.put((job, wave))
            except BaseException as e:          # surface to the submitter
                job.error = e
                self._finish(job)

    def _exec_loop(self) -> None:
        inflight: List[Tuple[WaveJob, object]] = []
        while True:
            if inflight:
                # a wave is executing: give the planner a moment to hand
                # over its successor so we dispatch N+1 BEFORE fetching N
                # (the overlap); if nothing is ready, the stream really
                # has gone dry — fetch and deliver rather than hold
                try:
                    item = self._planned.get(timeout=0.001)
                except queue.Empty:
                    self._fetch(*inflight.pop(0))
                    continue
            else:
                t0 = time.perf_counter()
                item = self._planned.get()
                self.stats["planner_wait_ms"] += (
                    (time.perf_counter() - t0) * 1e3)
            if item is None:
                self._drain(inflight)
                return
            job, wave = item
            try:
                if job.pre_dispatch is not None:
                    job.pre_dispatch()
                pending = self._dispatch(job, wave)
                inflight.append((job, pending))
                self.stats["pipeline_depth"] = len(inflight)
                while len(inflight) > 1:
                    self._fetch(*inflight.pop(0))
            except BaseException as e:
                job.error = e
                if wave.staged is not None:
                    wave.staged.release()     # after its guarded copies
                self._finish(job)

    def _dispatch(self, job: WaveJob, wave):
        """Dispatch with the staleness-replan loop.  The device-idle
        clock: if nothing was in flight when this dispatch lands, the
        gap since the previous wave finished was idle device time."""
        if self._inflight_n == 0:
            now = time.perf_counter()
            if self._device_free_since is not None:
                self.stats["device_idle_ms"] += (
                    (now - self._device_free_since) * 1e3)
        self._device_free_since = None
        while True:
            try:
                pending = self.engine.dispatch_batch(wave)
                self.stats["pipeline_waves"] += 1
                self._inflight_n += 1
                return pending
            except ValueError as e:
                if "stale plan" not in str(e):
                    raise
                # a write moved the runtime between plan and dispatch:
                # replan against the live state (PR 3 staleness machinery
                # — exactness by rejection, not locking).  The replanned
                # wave skips the staging ring: the planner thread may
                # legitimately hold the slot we just released (it blocks
                # on acquire while a full pipeline is outstanding), and
                # re-acquiring here would deadlock against our own
                # un-fetched in-flight wave.  One un-staged upload on the
                # rare replan path costs nothing.
                self.stats["pipeline_replans"] += 1
                if wave.staged is not None:
                    wave.staged.release()
                wave = self.engine.plan_batch(
                    job.queries, job.patterns, job.k,
                    ef_search=job.ef_search)

    def _fetch(self, job: WaveJob, pending) -> None:
        try:
            job.results = self.engine.fetch_batch(pending)
        except BaseException as e:
            job.error = e
        self._inflight_n -= 1
        if self._inflight_n == 0:
            # the device went quiet: any gap until the next dispatch is
            # idle time (≈0 on warm waves when the pipeline keeps up)
            self._device_free_since = time.perf_counter()
        self._finish(job)

    def _drain(self, inflight: List) -> None:
        while inflight:
            self._fetch(*inflight.pop(0))

    def _finish(self, job: WaveJob) -> None:
        with self._cv:
            self._completed += 1
            self.stats["pipeline_depth"] = max(
                0, self._submitted - self._completed)
            self._cv.notify_all()
        job.done.set()
        self._publish()

    def _publish(self) -> None:
        """Mirror the live counters into the engine so
        ``maintenance_stats`` exposes them without reaching into the
        executor (DESIGN.md §7 observability)."""
        st = dict(self.stats)
        if self._ring is not None:
            st["staging_grows"] = self._ring.grows
            st["staging_waits"] = self._ring.waits
            st["staging_stalls"] = self._ring.stalls
        self.engine.pipeline_stats.update(st)


__all__ = ["WaveJob", "PipelinedExecutor"]

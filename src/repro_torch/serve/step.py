"""The double-buffered host staging ring for the pipelined retrieval
executor.

Port of ``StagingStall``, ``StagingSlot`` and ``StagingRing`` from
``src/repro/serve/step.py``; its prefill/decode step functions wait for
the LM stack (ROADMAP Queue 1 item 10).

``StagingRing`` (DESIGN.md §7): the planner thread assembles wave N+1's
query matrix into one of two preallocated host buffers while wave N's
launches execute, so wave formation never allocates on the hot path and
the upload for wave N+1 reads from a buffer the in-flight wave cannot
touch.  A slot is held from planning until the wave's results are
fetched; with a depth-1 plan queue plus one in-flight wave, two slots
are exactly enough and ``acquire`` throttles the planner when it runs
more than a full pipeline ahead.

On a CUDA engine the slots are pinned host tensors (``pin=True``), so
the wave's query upload is an asynchronous copy (``non_blocking=True``)
on the wave's stream.  Such a copy still reads the slot after the host
has moved on: the dispatch stage marks the slot with ``guard()`` (a CUDA
event after the wave's launches), and ``release()`` waits for that event
before the slot can be refilled.  Unpinned slots (a CPU engine) are
plain buffers; pinning is never attempted there, and a failure to pin
raises.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch


class StagingStall(TimeoutError):
    """A staging-slot lease timed out: every upload slot stayed leased
    past the deadline, i.e. the fetch stage is not draining and the
    pipeline is wedged.  Carries the ring depth and the observed wait so
    the stall is diagnosable (and countable in ``maintenance_stats`` via
    ``staging_stalls``) instead of surfacing as an anonymous
    ``TimeoutError``."""

    def __init__(self, depth: int, wait_ms: float):
        super().__init__(
            f"StagingRing.acquire: all {depth} upload slots leased after "
            f"{wait_ms:.0f} ms — the fetch stage is not draining "
            f"(pipeline stalled)")
        self.depth = depth
        self.wait_ms = wait_ms


class StagingSlot:
    """One leased buffer of a ``StagingRing``: ``view(n)`` is the filled
    (n, d) prefix as an array, ``tensor(n)`` the same memory as a
    (pinned) tensor the dispatch stage uploads from; ``release()``
    returns the slot to the ring (idempotent) once every copy that reads
    it has completed."""

    def __init__(self, ring: "StagingRing", idx: int, n: int) -> None:
        self._ring = ring
        self._idx = idx
        self._n = n
        self._event: Optional[torch.cuda.Event] = None

    def view(self, n: Optional[int] = None) -> np.ndarray:
        return self._ring._views[self._idx][:self._n if n is None else n]

    def tensor(self, n: Optional[int] = None) -> torch.Tensor:
        return self._ring._bufs[self._idx][:self._n if n is None else n]

    @property
    def pinned(self) -> bool:
        return self._ring.pin

    def guard(self) -> None:
        """Mark the slot as read by the work queued so far on the current
        CUDA stream (an asynchronous upload from it): ``release`` waits
        for that work.  No-op for an unpinned slot, whose copies are
        synchronous."""
        if self._ring.pin and self._idx >= 0:
            self._event = torch.cuda.Event()
            self._event.record()

    def release(self) -> None:
        if self._idx >= 0:
            if self._event is not None:
                self._event.synchronize()
                self._event = None
            self._ring._release(self._idx)
            self._idx = -1


class StagingRing:
    """Double-buffered host staging for wave query matrices.

    ``acquire(queries)`` copies the wave's (n, d) query rows into a free
    preallocated slot (growing the slot's row capacity geometrically if
    the wave is larger than anything seen), blocking while both slots
    are leased — i.e. while a full pipeline (one planned + one in-flight
    wave) is outstanding.  This bounds planner run-ahead without a
    second queue and makes wave formation allocation-free at steady
    state.  ``pin=True`` allocates the slots in page-locked memory."""

    def __init__(self, dim: int, capacity: int = 64, slots: int = 2,
                 pin: bool = False) -> None:
        self.dim = int(dim)
        self.pin = bool(pin)
        self._bufs = [self._alloc(capacity) for _ in range(slots)]
        self._views = [b.numpy() for b in self._bufs]
        self._free = list(range(slots))
        self._cv = threading.Condition()
        self.grows = 0          # observability: hot-path reallocations
        self.waits = 0          # acquire() calls that had to block
        self.stalls = 0         # leases that timed out (StagingStall)

    def _alloc(self, rows: int) -> torch.Tensor:
        return torch.empty((rows, self.dim), dtype=torch.float32,
                           pin_memory=self.pin)

    def acquire(self, queries: np.ndarray,
                timeout: Optional[float] = None) -> StagingSlot:
        q = np.asarray(queries, dtype=np.float32)
        n = q.shape[0]
        t0 = time.perf_counter()
        with self._cv:
            if not self._free:
                self.waits += 1
            if not self._cv.wait_for(lambda: bool(self._free),
                                     timeout=timeout):
                self.stalls += 1
                raise StagingStall(
                    depth=len(self._bufs),
                    wait_ms=(time.perf_counter() - t0) * 1e3)
            idx = self._free.pop()
        if self._bufs[idx].shape[0] < n:
            self._bufs[idx] = self._alloc(max(n, self._bufs[idx].shape[0]
                                              * 2))
            self._views[idx] = self._bufs[idx].numpy()
            self.grows += 1
        self._views[idx][:n] = q
        return StagingSlot(self, idx, n)

    def _release(self, idx: int) -> None:
        with self._cv:
            self._free.append(idx)
            self._cv.notify()


__all__ = ["StagingStall", "StagingSlot", "StagingRing"]

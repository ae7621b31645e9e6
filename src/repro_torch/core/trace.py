"""Host spans of one index: where a wave's host time goes (DESIGN.md §7).

A ``Trace`` belongs to a ``VectorMaton`` and is handed to every
``PackedRuntime`` generation it builds, so its totals outlive a
compaction; a bare ``PackedRuntime`` makes its own.  Spans are named
``<layer>.<stage>`` and listed in ``SPANS``; the serving code opens them
at each stage boundary of a read wave.

Always kept, per name: the count, the total seconds and the seconds that
child spans cover (self time = total - children).  Each thread keeps its
own totals, merged when read, so the pipelined batcher's planner and
executor threads lose no update; a span's parent is the span open below
it on its own thread.  Only while ``recording`` is on does a span also
leave a record (name, start and end on ``time.perf_counter``, parent,
thread, wave index, request ticket), kept in memory until read, up to
``cap`` records a thread (``_CAP``), past which ``dropped`` counts.  A
thread keeps its records as plain values in one flat list, so that
recording adds no object for the garbage collector to scan;
``records()`` makes ``Record`` tuples of them.  The clock is the one
``torch.profiler`` traces are mapped onto by a host anchor, so records
name the device's idle gaps.

With records off a span costs what the wave pays for it on every run,
so the path is lean: each thread holds one ``Span`` a name, made once
and reused (a span nested in one of its own name gets a fresh one), and
the open spans form a chain through ``up``, not a list.
``ContinuousBatcher.submit`` runs once a request: its pair of spans
(``batcher.submit`` and the child ``planner.compile``) takes the leaner
path ``request``, three sums, since the code path fixes the parent.
``batcher.queue_wait`` is a total without records: the seconds from
each request's arrival to the admission that takes it into a wave.
"""

from __future__ import annotations

import threading
from time import perf_counter
from typing import Dict, List, NamedTuple, Optional, Tuple

SPANS = (
    # serve.batching
    "batcher.submit", "planner.compile", "batcher.queue_wait",
    "batcher.wave", "batcher.admit", "batcher.wait", "batcher.respond",
    # serve.engine, VectorMaton.query_batch
    "planner.plan",
    # core.packed: PackedRuntime.dispatch
    "executor.dispatch", "executor.queries", "executor.gather",
    "executor.scan_assemble", "executor.scan_launch",
    "executor.sq8_certificate", "executor.graphs", "executor.graph_masks",
    "executor.graph_assemble", "executor.graph_launch",
    "executor.residual", "executor.merge_dispatch", "executor.host_copies",
    # core.packed: PackedRuntime.fetch
    "executor.fetch", "executor.device_wait", "executor.assemble",
)

# ``PackedRuntime.wave_times``' stage keys (``maintenance_stats``'
# ``time_*``), each the total ms of its spans
STAGE_MS = {
    "plan_ms": ("planner.plan",),
    "upload_ms": ("executor.scan_assemble",),
    "launch_ms": ("executor.scan_launch", "executor.graphs"),
    "merge_ms": ("executor.merge_dispatch", "executor.host_copies",
                 "executor.assemble"),
    "wait_ms": ("executor.device_wait",),
}

_CAP = 1 << 20          # records kept a thread


class Record(NamedTuple):
    name: str
    start: float            # time.perf_counter seconds
    end: float
    parent: Optional[str]   # the span open below it on its thread
    thread: int             # threading.get_ident()
    wave: Optional[int]
    ticket: Optional[int]


_FIELDS = len(Record._fields)


class Span:
    """One name's timer on one thread, and its totals (``n``, ``total``
    and ``child`` seconds).  ``with`` times one interval; ``seconds``
    holds its duration once closed.  ``home``: the timer whose totals
    the interval adds to (itself, but for a span nested in one of its
    own name)."""

    __slots__ = ("_trace", "_th", "name", "home", "n", "total", "child",
                 "t0", "kids", "up", "open", "seconds")

    def __init__(self, trace: "Trace", th: "_Thread", name: str,
                 home: Optional["Span"] = None) -> None:
        self._trace = trace
        self._th = th
        self.name = name
        self.home = self if home is None else home
        self.n = 0
        self.total = 0.0
        self.child = 0.0
        self.up: Optional[Span] = None
        self.open = False
        self.seconds = 0.0

    def __enter__(self) -> "Span":
        th = self._th
        self.up = th.top
        th.top = self
        self.kids = 0.0
        self.open = True
        self.t0 = perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> None:
        t1 = perf_counter()
        dt = self.seconds = t1 - self.t0
        up = self.up
        th = self._th
        th.top = up
        self.open = False
        home = self.home
        home.n += 1
        home.total += dt
        home.child += self.kids
        if up is not None:
            up.kids += dt
        if self._trace.recording:
            th.keep(self.name, self.t0, t1,
                    None if up is None else up.name, th.ident, th.wave,
                    None)


class _Thread:
    """One thread's spans (name -> ``Span``), innermost open span
    (``top``), wave index, the lean pair's sums (``req``: requests,
    submit seconds, compile seconds) and records (``_FIELDS`` values a
    record, flat)."""

    __slots__ = ("trace", "spans", "top", "wave", "ident", "req", "rec",
                 "dropped")

    def __init__(self, trace: "Trace") -> None:
        self.trace = trace
        self.spans = {n: Span(trace, self, n) for n in SPANS}
        self.top: Optional[Span] = None
        self.wave: Optional[int] = None
        self.ident = threading.get_ident()
        self.req = [0, 0.0, 0.0]
        self.rec: list = []
        self.dropped = 0

    def keep(self, *values) -> None:
        if len(self.rec) < self.trace.cap * _FIELDS:
            self.rec.extend(values)
        else:
            self.dropped += 1


class _Local(threading.local):
    """``th``: the calling thread's ``_Thread``, made and registered with
    the trace on the thread's first use."""

    def __init__(self, trace: "Trace") -> None:
        self.th = _Thread(trace)
        with trace._lock:
            trace._threads.append(self.th)


class Trace:
    """Span totals and, while ``recording``, span records of one index."""

    def __init__(self) -> None:
        self.recording = False
        self.cap = _CAP                     # records kept a thread
        self._threads: List[_Thread] = []
        self._lock = threading.Lock()
        self._local = _Local(self)

    # ---- writing ------------------------------------------------------ #

    def span(self, name: str, wave: Optional[int] = None) -> Span:
        """``with trace.span(name):`` times the block (a name of
        ``SPANS``, else ``KeyError``).  ``wave``: the wave index this
        thread's spans carry from here on."""
        th = self._local.th
        if wave is not None:
            th.wave = wave
        sp = th.spans[name]
        return sp if not sp.open else Span(self, th, name, home=sp)

    def set_wave(self, wave: Optional[int]) -> None:
        """The wave index this thread's spans carry from here on (a
        pipeline thread, which opens no ``batcher.wave``)."""
        self._local.th.wave = wave

    def request(self, t0: float, c0: float, c1: float, t1: float,
                ticket: int) -> None:
        """One request's submit, ``t0``..``t1``, and its predicate
        compile, ``c0``..``c1``, inside it (``perf_counter`` readings)."""
        th = self._local.th
        r = th.req
        r[0] += 1
        r[1] += t1 - t0
        r[2] += c1 - c0
        if self.recording:
            th.keep("batcher.submit", t0, t1, None, th.ident, th.wave,
                    ticket)
            th.keep("planner.compile", c0, c1, "batcher.submit", th.ident,
                    th.wave, ticket)

    def add(self, name: str, count: int, seconds: float) -> None:
        """Add ``count`` intervals of ``seconds`` in all to a total that
        has no span of its own (``batcher.queue_wait``)."""
        sp = self._local.th.spans[name]
        sp.n += count
        sp.total += seconds

    # ---- reading ------------------------------------------------------ #

    def _all(self) -> List[_Thread]:
        with self._lock:
            return list(self._threads)

    def totals(self) -> Dict[str, Tuple[int, float, float]]:
        """name -> (count, total s, self s), summed over threads; every
        name of ``SPANS``, zero where none ran."""
        acc = {n: [0, 0.0, 0.0] for n in SPANS}
        for th in self._all():
            for n, sp in th.spans.items():
                a = acc[n]
                a[0] += sp.n
                a[1] += sp.total
                a[2] += sp.child
            reqs, submit_s, compile_s = th.req
            for n, s, ch in (("batcher.submit", submit_s, compile_s),
                             ("planner.compile", compile_s, 0.0)):
                a = acc[n]
                a[0] += reqs
                a[1] += s
                a[2] += ch
        return {n: (c, s, s - ch) for n, (c, s, ch) in acc.items()}

    def table(self) -> Dict[str, Dict[str, float]]:
        """name -> {"n", "ms", "self_ms"} for every span that ran
        (``maintenance_stats()["spans"]``)."""
        return {n: {"n": c, "ms": s * 1e3, "self_ms": own * 1e3}
                for n, (c, s, own) in self.totals().items() if c}

    def wave_times(self) -> Dict[str, float]:
        """The stage totals of ``STAGE_MS`` in ms, then each span's
        ``span.<name>.n``, ``.ms`` and ``.self_ms``: a fixed set of keys,
        so two readings subtract key by key."""
        tot = self.totals()
        out = {key: sum(tot[n][1] for n in names) * 1e3
               for key, names in STAGE_MS.items()}
        for n, (c, s, own) in tot.items():
            out[f"span.{n}.n"] = c
            out[f"span.{n}.ms"] = s * 1e3
            out[f"span.{n}.self_ms"] = own * 1e3
        return out

    @property
    def dropped(self) -> int:
        """Records not kept since the last ``clear``: past the cap."""
        return sum(th.dropped for th in self._all())

    def records(self) -> List[Record]:
        """The records kept so far, thread by thread, each thread's in
        the order its spans closed."""
        out: List[Record] = []
        for th in self._all():
            flat = th.rec[:]
            out += [Record(*flat[i:i + _FIELDS])
                    for i in range(0, len(flat), _FIELDS)]
        return out

    def spans(self) -> List[Tuple[str, float, float]]:
        """The records as (name, start, end) host spans, the form the
        benchmark's trace reader labels idle gaps with."""
        return [(r.name, r.start, r.end) for r in self.records()]

    def clear(self) -> None:
        """Drop the records kept so far (totals stay)."""
        for th in self._all():
            th.rec.clear()
            th.dropped = 0


__all__ = ["Record", "SPANS", "STAGE_MS", "Span", "Trace"]

"""One run of one cell: inputs from the seed, the index built through the
program's normal path, a closed loop of requests through the continuous
batcher, the answers held to the plain reference, one result line.

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell's configuration file and traffic mix,
``traffic/<mix>.json`` holds the mix, and every metric named in
``BENCHMARK.json`` has a reader ``metrics/<name>.py`` with
``read(run) -> float | None`` over the ``RunRecord`` below.  A reader
that finds nothing returns None and its metric is left out of the line.

Set-up is the time from process start to the opening of the window:
imports, input generation, the host build, the upload, the first wave
(which builds or loads the kernel library) and the warm-up waves.  The
window then runs whole waves until ``--seconds`` have passed; the
end-to-end and counter metrics read it.  With ``--trace 1``,
``TRACE_SECONDS`` more of whole waves follow under ``torch.profiler``,
which the device metrics read.  Every answer of both is checked.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import data, devtrace, guard, reference

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
WARMUP_WAVES = 32
TRACE_SECONDS = 3.0


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT /
                                                      "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    if traffic["loop"] != "closed" or traffic["tenants"] != 1:
        raise SystemExit(f"traffic {w['traffic']!r}: only a closed loop of "
                         "one tenant is driven")
    return Cell(name, int(w["chips"]), load_json(ROOT / conf["file"]),
                traffic, _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def load_reader(metric: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"vmbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ #
# what a run records; the metric readers read this
# ------------------------------------------------------------------ #

@dataclass
class RunRecord:
    config: dict
    setup_s: float = 0.0
    peak_bytes: int = 0
    window_s: float = 0.0                 # host clock, whole waves
    latencies_s: np.ndarray = field(default_factory=lambda: np.empty(0))
    # counters over the untraced waves of the window
    waves: int = 0
    answered: int = 0
    wave_times: Dict[str, float] = field(default_factory=dict)
    sq8: Dict[str, int] = field(default_factory=dict)
    sizes: Dict[str, int] = field(default_factory=dict)   # |V_p|
    profile: Optional[devtrace.ProfileRecord] = None


@dataclass
class Inputs:
    rows: np.ndarray
    sequences: List[str]
    queries: np.ndarray
    predicates: List[str]


def make_inputs(cfg: dict, traffic: dict, seed: int, device: str) -> Inputs:
    rows, norms = data.make_rows(cfg, seed, device)
    tags = [tuple(t) for t in cfg["tags"]]
    seqs = data.sequences_of(data.tag_codes(len(rows), tags, seed), tags,
                             cfg["terminal"])
    queries = data.make_queries(rows, norms, int(traffic["query_pool"]),
                                float(traffic["query_noise"]), seed)
    return Inputs(rows, seqs, queries, [p for p, _ in traffic["block"]])


# ------------------------------------------------------------------ #
# the program under test
# ------------------------------------------------------------------ #

class Spans:
    """The harness's own host spans (name, start, end on the host clock),
    kept while ``on``: around the calls into the batcher and around the
    engine's three stages, whichever thread runs them."""

    def __init__(self) -> None:
        self.on = False
        self.items: List[tuple] = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.items.append((name, t0, time.perf_counter()))
        return wrapped

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.on:
                self.items.append((name, t0, time.perf_counter()))


class Client:
    """The closed loop: ``outstanding`` requests always queued; every
    answer that comes back is replaced by a new request at once.  A
    request's latency runs from just before ``submit`` to the return of
    the ``run_wave`` that answered it."""

    def __init__(self, batcher, inputs: Inputs, traffic: dict, seed: int,
                 spans: Optional["Spans"]) -> None:
        from repro_torch.serve.engine import Request
        self._request = Request
        self.batcher = batcher
        self.inputs = inputs
        self.k = int(traffic["k"])
        self.schedule = data.Schedule(traffic, seed)
        self.meta: Dict[int, tuple] = {}
        self.waves = 0
        batcher.on_wave_start = self._count_wave
        self.spans = spans

    def _count_wave(self, _index: int) -> None:
        self.waves += 1

    def submit(self, n: int) -> None:
        q, preds = self.inputs.queries, self.inputs.predicates
        for _ in range(n):
            _, p, qi = self.schedule.next()
            t = time.perf_counter()
            ticket = self.batcher.submit(self._request(
                vector=q[qi], pattern=preds[p], k=self.k))
            self.meta[ticket] = (p, qi, t)

    def wave(self):
        """One ``run_wave``; returns [(pred, query, latency, ids, dist)]
        and refills the loop."""
        if self.spans is None:
            out = self.batcher.run_wave()
            done = time.perf_counter()
            ans = [(*self._close(t, done), r.ids, r.distances)
                   for t, r in out.items()]
            self.submit(len(ans))
            return ans
        with self.spans.span("vmbench.run_wave"):
            out = self.batcher.run_wave()
        done = time.perf_counter()
        with self.spans.span("vmbench.client"):
            ans = [(*self._close(t, done), r.ids, r.distances)
                   for t, r in out.items()]
        with self.spans.span("vmbench.submit"):
            self.submit(len(ans))
        return ans

    def drain(self):
        """Answer every request still outstanding, submitting no more."""
        ans = []
        while self.meta:
            out = self.batcher.run_wave()
            if not out:
                raise RuntimeError(f"{len(self.meta)} requests outstanding "
                                   "and the batcher answered none")
            done = time.perf_counter()
            ans += [(*self._close(t, done), r.ids, r.distances)
                    for t, r in out.items()]
        return ans

    def _close(self, ticket: int, done: float):
        p, qi, t = self.meta.pop(ticket)
        return p, qi, done - t


def _counters(engine) -> dict:
    rt = engine.index.runtime
    return {"wave_times": dict(rt.wave_times), "sq8": dict(rt.sq8_stats)}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in b}


def _wave_clock(ends: List[float], t_open: float, sizes: List[int]
                ) -> dict:
    """The window's waves on the host clock: wave-time quantiles (ms)
    and the requests answered in each whole second."""
    if not ends:
        return {}
    t = np.asarray(ends)
    dt = np.diff(np.concatenate([[t_open], t])) * 1e3
    sec = np.floor(t - t_open).astype(int)
    per_s = np.bincount(sec, weights=np.asarray(sizes[-len(t):], float))
    return {"wave_ms": {q: float(np.percentile(dt, q))
                        for q in (5, 50, 95, 100)},
            "answered_by_second": per_s.tolist()}


def _guard(on: bool) -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's; with ``on`` a run that holds one ends here, naming them."""
    bad = guard.forbidden_modules(sys.modules)
    if bad and on:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)
    return bad


class GcPauses:
    """Python's garbage collections while registered in ``gc.callbacks``:
    count and host seconds by generation."""

    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0: Optional[float] = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Log:
    """The window's answers, kept for the check."""

    def __init__(self, k: int) -> None:
        self.k = k
        self.pred: List[int] = []
        self.query: List[int] = []
        self.lat: List[float] = []
        self.ids: List[np.ndarray] = []
        self.dist: List[np.ndarray] = []
        self.wave_sizes: List[int] = []

    def add(self, answers) -> None:
        self.wave_sizes.append(len(answers))
        for p, qi, lat, ids, dist in answers:
            self.pred.append(p)
            self.query.append(qi)
            self.lat.append(lat)
            self.ids.append(np.asarray(ids))
            self.dist.append(np.asarray(dist))

    def answers(self) -> reference.Answers:
        """(R, W) arrays, W = k or the longest answer if longer."""
        n = len(self.pred)
        w = max([self.k] + [len(i) for i in self.ids])
        ids = np.full((n, w), -1, np.int64)
        dist = np.full((n, w), np.nan)
        for r, (i, d) in enumerate(zip(self.ids, self.dist)):
            ids[r, :len(i)] = i
            dist[r, :len(d)] = d
        return reference.Answers(ids, dist)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False, out=emit,
             import_guard: bool = True) -> dict:
    """One run; returns the result line's object (``control``: also the
    control's readings, under ``"control"``).  ``import_guard``: fail at
    the end of set-up when JAX or the JAX package is loaded (off only in
    a test process, which holds the JAX package's tests too); ``main``
    checks again before it prints the result."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    from repro_torch.core.vectormaton import VectorMatonConfig
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.engine import RetrievalEngine

    t0 = time.perf_counter()
    inputs = make_inputs(cfg, traffic, seed, device)
    t1 = time.perf_counter()
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    engine = RetrievalEngine(
        inputs.rows, inputs.sequences,
        VectorMatonConfig(backend="torch", device=device, **cfg["index"]))
    t2 = time.perf_counter()
    engine.index.runtime.to_device()
    _sync(device)
    t3 = time.perf_counter()
    spans = Spans() if trace else None
    if trace:
        for name in ("plan_batch", "dispatch_batch", "fetch_batch"):
            # on the instance: the batcher's threads look them up there
            setattr(engine, name,
                    spans.wrap(f"engine.{name}", getattr(engine, name)))
    batcher = ContinuousBatcher(engine, **cfg["batcher"])
    client = Client(batcher, inputs, traffic, seed, spans)
    log = Log(client.k)
    client.submit(int(traffic["outstanding"]))
    client.wave()
    t4 = time.perf_counter()
    for _ in range(WARMUP_WAVES - 1):
        client.wave()
    _sync(device)
    bad = _guard(import_guard)
    rt_stats = engine.index.runtime.stats()
    t_open = time.perf_counter()
    rec = RunRecord(cfg, setup_s=t_open - t_start)
    out(stage="setup", setup_s=rec.setup_s, imports_s=t0 - t_start,
        generate_s=t1 - t0, build_s=t2 - t1, upload_s=t3 - t2,
        first_wave_s=t4 - t3, warmup_s=t_open - t4, rows=len(inputs.rows),
        dim=int(inputs.rows.shape[1]), index=rt_stats)
    out(stage="guard", forbidden=bad,
        yardstick_imports=guard.yardstick_imports())

    # ---- the window ---------------------------------------------------
    c0, w0 = _counters(engine), client.waves
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    ends = []
    while time.perf_counter() - t_open < seconds:
        log.add(client.wave())
        ends.append(time.perf_counter())
    t_close = time.perf_counter()
    gc.callbacks.remove(pauses)
    clock = _wave_clock(ends, t_open, log.wave_sizes)
    rec.window_s = t_close - t_open
    rec.latencies_s = np.asarray(log.lat)
    rec.answered = len(log.pred)
    rec.waves = client.waves - w0
    c1 = _counters(engine)
    rec.wave_times = _delta(c0["wave_times"], c1["wave_times"])
    rec.sq8 = _delta(c0["sq8"], c1["sq8"])
    if device.startswith("cuda"):
        rec.peak_bytes = int(torch.cuda.max_memory_allocated())
    if trace:
        rec.profile = traced_waves(engine, client, log, spans, device, out)
    log.add(client.drain())
    strategies = {p: [s.strategy for s in engine.index.compile(p).sources]
                  for p in inputs.predicates}
    from repro_torch.kernels import ops
    out(stage="window", answered=rec.answered, waves=rec.waves,
        window_s=rec.window_s,
        latency_ms={q: float(np.percentile(rec.latencies_s, q)) * 1e3
                    for q in (50, 95, 99, 100)} if rec.answered else None,
        strategies=strategies, sq8_stats=engine.index.runtime.sq8_stats,
        wave_times_ms=engine.index.runtime.wave_times,
        launch_stats=ops.launch_stats(), peak_bytes=rec.peak_bytes,
        gc_collections=pauses.count, gc_seconds=pauses.seconds, **clock)

    # ---- free the program, then the reference -------------------------
    batcher.close()
    del client, batcher, engine
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict, ctrl, sizes = check(cfg, inputs, log, device, control)
    rec.sizes = sizes
    out(stage="check", reference_s=time.perf_counter() - t_ref,
        requests=len(log.pred), numbers=verdict.numbers,
        failed=verdict.failed,
        control=None if ctrl is None else ctrl.numbers)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name() if device.startswith("cuda")
                    else "cpu"),
           "count": 1, "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": verdict.correct, "attempted": len(log.pred),
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile.busy_s
        dev["window_s"] = rec.profile.window_s
        result["breakdown"] = {"device_ops": rec.profile.device_ops(),
                               "idle_gaps": rec.profile.idle_gaps()}
    if ctrl is not None:
        result["control"] = {"correct": ctrl.correct, "failed": ctrl.failed,
                             "numbers": ctrl.numbers}
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, (v, lim) in verdict.numbers.items()}
    return result


def traced_waves(engine, client: Client, log: "Log", spans: Spans,
                 device: str, out) -> devtrace.ProfileRecord:
    """``TRACE_SECONDS`` of whole waves under ``torch.profiler``, after
    the window.  The profiler's first start (seconds, on a card) is paid
    before them, on an empty trace.  Each wave's predicate counts and SQ8
    counter steps are kept for the roofline readers; its answers join the
    checked ones."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        _sync(device)
    t1 = time.perf_counter()
    rt = engine.index.runtime
    waves: List[dict] = []
    spans.items.clear()
    spans.on = True
    with profile(activities=acts) as prof:
        _sync(device)
        with record_function(devtrace.WINDOW_SPAN):
            anchor = time.perf_counter()
            while time.perf_counter() - anchor < TRACE_SECONDS:
                s0 = dict(rt.sq8_stats)
                ans = client.wave()
                counts: Dict[str, int] = {}
                for p, *_ in ans:
                    name = client.inputs.predicates[p]
                    counts[name] = counts.get(name, 0) + 1
                waves.append({"counts": counts,
                              "sq8": _delta(s0, rt.sq8_stats)})
                log.add(ans)
            _sync(device)
        t2 = time.perf_counter()
    spans.on = False
    record = devtrace.read_profile(prof, spans.items, anchor, t2 - anchor)
    record.waves = waves
    out(stage="trace", profiler_start_s=t1 - t0, waves=len(waves),
        host_window_s=t2 - anchor, trace_window_s=record.window_s,
        busy_s=record.busy_s, read_s=time.perf_counter() - t2)
    return record


def check(cfg: dict, inputs: Inputs, log: Log, device: str,
          control: bool):
    """The window's answers against the exact reference (and, with
    ``control``, the control's answers to the same requests)."""
    metric = cfg["index"].get("metric", "l2")
    k = log.k
    table = torch.from_numpy(inputs.rows).to(device)
    max_sq = float((table.double() ** 2).sum(1).max())
    matcher = reference.Matcher(inputs.sequences)
    members = [matcher.member(p) for p in inputs.predicates]
    sizes = {p: int(m.sum()) for p, m in zip(inputs.predicates, members)}
    pred = np.asarray(log.pred, np.int64)
    queries = inputs.queries[np.asarray(log.query, np.int64)] if len(pred) \
        else np.empty((0, table.shape[1]), np.float32)
    exact = reference.Answers(np.full((len(pred), k), -1, np.int64),
                              np.full((len(pred), k), np.nan))
    ctl = (reference.Answers(exact.ids.copy(), exact.dist.copy())
           if control else None)
    for p, mask in enumerate(members):
        rs = np.nonzero(pred == p)[0]
        if not len(rs):
            continue
        rows = np.nonzero(mask)[0]
        a = reference.topk(table, rows, queries[rs], k, metric)
        exact.ids[rs], exact.dist[rs] = a.ids, a.dist
        if control:
            c = reference.topk(table, rows, queries[rs], k, metric,
                               control=True)
            ctl.ids[rs], ctl.dist[rs] = c.ids, c.dist
    limits = cfg["limits"]
    verdict = reference.judge_requests(table, queries, pred, members,
                                       log.answers(), exact, max_sq,
                                       metric, limits)
    cverdict = (reference.judge_requests(table, queries, pred, members, ctl,
                                         exact, max_sq, metric, limits)
                if control else None)
    return verdict, cverdict, sizes


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=t_start)
    # last, after the reference and every metric reader have loaded
    _guard(True)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

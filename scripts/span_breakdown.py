#!/usr/bin/env python3
"""The program's host spans in the benchmark's cells: where a wave's host
time goes, which span holds the device idle, and what the spans cost.

    python3 scripts/span_breakdown.py trace --cells sift1m-tags.mix \\
        --seed 7 --seconds 51
    python3 scripts/span_breakdown.py records --cell sift1m-tags.mix \\
        --seed 7 --pairs 40 --window 2 --states off,parent \\
        --parent build/parent/src/repro_torch
    python3 scripts/span_breakdown.py cost          # host CPU, no card

``trace`` runs ``vmbench``'s traced run of each cell with the index's
span records on during the traced window and handed to the trace reader
beside the harness's own spans, so each idle gap of the device carries
the name of the innermost program stage open across it.  It prints the
result line's metrics and breakdown, and a ``spans`` line: each span's
count, total ms and self ms a wave over the untraced window.  This mode
stands in for two additions to ``vmbench/harness.py`` and goes with
them: ``traced_waves`` turning the index's records on with its own
``spans.on`` and handing ``spans.items + trace.spans()`` to
``devtrace.read_profile``, and ``run_cell`` printing the ``spans`` line.
Until then it reaches into the harness's private names.
``records`` builds one cell in one process and runs ``--pairs`` rounds
of windows, in turns: records off (as the benchmark runs), records on,
or another commit's package serving the same inputs (see
``run_records``).  ``cost`` times a span, a nested span and
a request's lean pair with records off and on, in ns.  ``trace`` and
``records`` need a card unless ``--device cpu`` (with ``--rows``, to
rehearse at a size the host holds).  Lines are JSON.
"""

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def load(name: str, args):
    """The cell, cut to ``--rows`` / ``--outstanding`` where given."""
    from vmbench import harness
    cell = harness.load_cell(name)
    if args.rows:
        cell.config = dict(cell.config, rows=args.rows)
    if args.outstanding:
        cell.traffic = dict(cell.traffic, outstanding=args.outstanding)
        cell.config = dict(cell.config, batcher=dict(
            cell.config["batcher"],
            max_wave=min(args.outstanding // 4,
                         cell.config["batcher"]["max_wave"])))
    return cell


def per_wave(delta: dict) -> dict:
    """span -> [count, total ms, self ms] a wave, from two readings of
    ``wave_times``; waves are ``batcher.wave`` spans."""
    from repro_torch.core.trace import SPANS
    waves = delta["span.batcher.wave.n"] or 1
    return {n: [delta[f"span.{n}.n"] / waves, delta[f"span.{n}.ms"] / waves,
                delta[f"span.{n}.self_ms"] / waves]
            for n in SPANS if delta[f"span.{n}.n"]}


def warm_record_function() -> float:
    """Pay ``record_function``'s one-time set-up before a window's anchor
    is taken inside one; returns what it took (us)."""
    from torch.profiler import record_function
    t0 = time.perf_counter()
    with record_function("span_breakdown.warm"):
        pass
    return (time.perf_counter() - t0) * 1e6


def run_trace(args) -> int:
    from vmbench import devtrace, harness
    counters, real_counters = [], harness._counters
    real_traced, real_read = harness.traced_waves, devtrace.read_profile

    def with_records(engine, client, log, spans, device, out):
        tr = engine.index.trace

        def read(prof, host_spans, anchor, window_s):
            return real_read(prof, list(host_spans) + tr.spans(), anchor,
                             window_s)

        tr.clear()
        tr.recording = True
        devtrace.read_profile = read
        try:
            return real_traced(engine, client, log, spans, device, out)
        finally:
            tr.recording = False
            devtrace.read_profile = real_read
            emit(stage="records", kept=len(tr.records()),
                 dropped=tr.dropped)

    def keep(engine):
        counters.append(real_counters(engine))
        return counters[-1]

    harness._counters = keep
    harness.traced_waves = with_records
    lag = warm_record_function()
    for name in args.cells.split(","):
        counters.clear()
        res = harness.run_cell(load(name, args), args.seed, args.seconds,
                               trace=True, device=args.device,
                               out=lambda **kw: None,
                               import_guard=False)
        delta = harness._delta(counters[0]["wave_times"],
                               counters[1]["wave_times"])
        emit(stage="spans", cell=name, seed=args.seed,
             spans=per_wave(delta))
        emit(stage="result", cell=name, seed=args.seed, card=card(),
             record_function_setup_us=lag, correct=res["correct"],
             metrics={k: v["value"] for k, v in res["metrics"].items()},
             device=res["device"], breakdown=res.get("breakdown"))
    return 0


def load_parent(path: str):
    """The package at ``path`` (a ``repro_torch`` of another commit),
    imported as ``repro_torch_parent`` beside this tree's."""
    import importlib
    import importlib.util
    init = Path(path).resolve() / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_parent", init,
        submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_parent"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("repro_torch_parent.core.vectormaton"),
            importlib.import_module("repro_torch_parent.serve.batching"),
            importlib.import_module("repro_torch_parent.serve.engine"))


def run_records(args) -> int:
    """Windows in turns in one process, each of ``--states``: ``off``
    (records off, as the benchmark runs), ``on`` (records on) and
    ``parent`` (the package at ``--parent`` serving the same inputs
    through its own engine).  ``--order`` builds the engines in that
    order.  A round runs every state once, the order of the states
    rotating from round to round.  Each window reads the requests a
    second, the calling thread's CPU µs a request (``time.thread_time``)
    and Python's collections in it, by generation (count, seconds)."""
    import torch
    from repro_torch.core import vectormaton
    from repro_torch.serve import batching, engine as engine_mod
    from vmbench import harness
    states = tuple(args.states.split(","))
    cell = load(args.cell, args)
    cfg = cell.config
    inputs = harness.make_inputs(cfg, cell.traffic, args.seed, args.device)
    packages = {"change": (vectormaton, batching, engine_mod)}
    if "parent" in states:
        packages["parent"] = load_parent(args.parent)
    clients = {}
    for side in args.order.split(","):
        if side not in packages:
            continue
        vm_mod, b_mod, e_mod = packages[side]
        eng = e_mod.RetrievalEngine(
            inputs.rows, inputs.sequences,
            vm_mod.VectorMatonConfig(backend="torch", device=args.device,
                                     **cfg["index"]))
        eng.index.runtime.to_device()
        batcher = b_mod.ContinuousBatcher(eng, **cfg["batcher"])
        client = harness.Client(batcher, inputs, cell.traffic, args.seed,
                                None)
        client.submit(int(cell.traffic["outstanding"]))
        for _ in range(harness.WARMUP_WAVES):
            client.wave()
        clients[side] = client
    trace = clients["change"].batcher.engine.index.trace
    qps = {st: [] for st in states}
    cpu = {st: [] for st in states}
    for rnd in range(args.pairs):
        k = rnd % len(states)
        for st in states[k:] + states[:k]:
            client = clients["parent" if st == "parent" else "change"]
            rt = client.batcher.engine.index.runtime
            trace.clear()
            trace.recording = st == "on"
            w0 = rt.wave_times
            pauses = harness.GcPauses()
            gc.callbacks.append(pauses)
            answered = 0
            c0, t0 = time.thread_time(), time.perf_counter()
            while time.perf_counter() - t0 < args.window:
                answered += len(client.wave())
            dt = time.perf_counter() - t0
            dc = time.thread_time() - c0
            gc.callbacks.remove(pauses)
            trace.recording = False
            if args.device.startswith("cuda"):
                torch.cuda.synchronize()
            qps[st].append(answered / dt)
            cpu[st].append(dc / answered * 1e6)
            emit(stage="window", round=rnd, state=st, qps=answered / dt,
                 cpu_us_per_request=cpu[st][-1], gc_count=pauses.count,
                 gc_seconds=pauses.seconds,
                 kept=len(trace.records()), dropped=trace.dropped,
                 spans=(per_wave(harness._delta(w0, rt.wave_times))
                        if st != "parent" else None))
    for client in clients.values():
        client.batcher.close()
    out = dict(stage="records_cost", cell=args.cell, seed=args.seed,
               card=card(), window_s=args.window, order=args.order,
               qps=qps, cpu_us_per_request=cpu,
               median_qps={st: statistics.median(v) for st, v in qps.items()})
    for st in states:
        if st == "off":
            continue
        ratios = [a / b for a, b in zip(qps[st], qps["off"])]
        out[f"{st}_over_off"] = {
            "median_qps_ratio": statistics.median(ratios),
            "median_cpu_ratio": statistics.median(
                [a / b for a, b in zip(cpu[st], cpu["off"])]),
            "rounds_above": sum(r > 1 for r in ratios),
            "rounds": len(ratios)}
    emit(**out)
    return 0


def run_cost(args) -> int:
    """ns a span with records off and on: each loop's time less an empty
    loop's, the least of ``--repeat`` tries, the loops taken in turns so
    that a busy host slows them alike."""
    from time import perf_counter as pc
    from repro_torch.core.trace import Trace
    n = args.n
    trs = {False: Trace(), True: Trace()}
    trs[True].cap = n * args.repeat * 8
    trs[True].recording = True

    def empty(tr):
        for _ in range(n):
            pass

    def reading(tr):
        for _ in range(n):
            pc()

    def flat(tr):
        for _ in range(n):
            with tr.span("executor.gather"):
                pass

    def nested(tr):
        with tr.span("executor.dispatch"):
            for _ in range(n):
                with tr.span("executor.gather"):
                    pass

    def lean(tr):
        # submit's readings: the one it took before plus three
        for i in range(n):
            t0 = pc()
            c0 = pc()
            t = pc()
            tr.request(t0, c0, t, pc(), i)

    loops = (empty, reading, flat, nested, lean)
    best = {(f.__name__, on): float("inf") for f in loops
            for on in (False, True)}
    for _ in range(args.repeat):
        for on in (False, True):
            for f in loops:
                t0 = pc()
                f(trs[on])
                key = (f.__name__, on)
                best[key] = min(best[key], pc() - t0)
    res = {}
    for on in (False, True):
        base, one = best[("empty", on)], best[("reading", on)]
        per = {f.__name__: (best[(f.__name__, on)] - base) / n * 1e9
               for f in loops[1:]}
        res["records_on" if on else "records_off"] = {
            "span_ns": per["flat"], "nested_span_ns": per["nested"],
            # a request's two spans, less the one reading submit had
            "request_pair_ns": per["lean"] - per["reading"],
            "clock_reading_ns": per["reading"]}
    emit(stage="span_cost", n=n, repeat=args.repeat,
         python=sys.version.split()[0], **res)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for name in ("trace", "records"):
        p = sub.add_parser(name)
        p.add_argument("--seed", type=int, default=3100000105)
        p.add_argument("--device", default="cuda")
        p.add_argument("--rows", type=int, default=0)
        p.add_argument("--outstanding", type=int, default=0)
    t = sub.choices["trace"]
    t.add_argument("--cells", default="sift1m-tags.mix,glove100-tags.mix,"
                   "sift1m-tags.bool")
    t.add_argument("--seconds", type=float, default=51.0)
    r = sub.choices["records"]
    r.add_argument("--cell", default="sift1m-tags.mix")
    r.add_argument("--pairs", type=int, default=6)
    r.add_argument("--window", type=float, default=10.0)
    r.add_argument("--states", default="off,on")
    r.add_argument("--parent", default="build/parent/src/repro_torch",
                   help="another commit's src/repro_torch (``parent``)")
    r.add_argument("--order", default="change,parent",
                   help="the order the engines are built in")
    c = sub.add_parser("cost")
    c.add_argument("--n", type=int, default=20_000)
    c.add_argument("--repeat", type=int, default=41)
    args = ap.parse_args(argv)
    if args.mode != "cost" and args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("span_breakdown: no CUDA device", file=sys.stderr)
            return 2
    return {"trace": run_trace, "records": run_records,
            "cost": run_cost}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())

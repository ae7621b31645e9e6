"""The port's host spans (``repro_torch.core.trace``): nesting and self
time, records only while recording, the record cap, totals merged across
threads (the pipelined batcher's planner and executor threads among
them), ``wave_times`` read from the span totals, totals that outlive a
compaction, the spans of the device beam executor, and the spans in
``maintenance_stats``.  Everything runs on the CPU (``device="cpu"``)."""

import sys
import threading

import numpy as np
import pytest

from repro_torch.core import trace as trace_mod
from repro_torch.core.trace import STAGE_MS, SPANS, Trace
from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
from repro_torch.serve.batching import ContinuousBatcher
from repro_torch.serve.engine import Request, RetrievalEngine

DIM = 8
PREDS = ["ab", "a AND NOT c", "LIKE '%a%b%'", "cd OR ab"]
JOIN_S = 60.0


def _corpus(seed=3, n=400):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("abcd"), size=8)) for _ in range(n)]
    return rng.standard_normal((n, DIM)).astype(np.float32), seqs


@pytest.fixture
def clock(monkeypatch):
    """A fake ``perf_counter`` that hands out the listed readings."""
    readings = []
    monkeypatch.setattr(trace_mod, "perf_counter",
                        lambda: readings.pop(0))
    return readings


def test_nesting_and_self_time(clock):
    tr = Trace()
    tr.recording = True
    clock += [0.0, 1.0, 4.0, 5.0, 6.0, 10.0]
    with tr.span("batcher.wave", wave=7):
        with tr.span("batcher.admit"):
            pass
        with tr.span("planner.plan"):
            pass
    tot = tr.totals()
    assert tot["batcher.wave"] == (1, 10.0, 6.0)
    assert tot["batcher.admit"] == (1, 3.0, 3.0)
    assert tot["planner.plan"] == (1, 1.0, 1.0)
    recs = {r.name: r for r in tr.records()}
    assert recs["batcher.admit"].parent == "batcher.wave"
    assert recs["batcher.wave"].parent is None
    # children carry their ancestor's wave index
    assert {r.wave for r in recs.values()} == {7}
    assert (recs["planner.plan"].start, recs["planner.plan"].end) == (5.0,
                                                                      6.0)
    assert tr.spans()[0] == ("batcher.admit", 1.0, 4.0)


def test_span_nested_in_its_own_name(clock):
    """A thread reuses one timer a name: an inner span of the same name
    times itself apart and adds to the same totals."""
    tr = Trace()
    clock += [0.0, 2.0, 3.0, 10.0, 11.0, 12.0]
    with tr.span("executor.residual") as outer:
        with tr.span("executor.residual") as inner:
            pass
    assert (outer.seconds, inner.seconds) == (10.0, 1.0)
    with tr.span("executor.residual") as again:
        pass
    assert again is outer and again.seconds == 1.0
    assert tr.totals()["executor.residual"] == (3, 12.0, 11.0)


def test_lean_request_and_totals_without_span(clock):
    tr = Trace()
    tr.recording = True
    tr.request(1.0, 1.5, 3.5, 4.0, ticket=42)
    tr.add("batcher.queue_wait", 3, 0.25)
    tot = tr.totals()
    assert tot["batcher.submit"] == (1, 3.0, 1.0)
    assert tot["planner.compile"] == (1, 2.0, 2.0)
    assert tot["batcher.queue_wait"] == (3, 0.25, 0.25)
    sub, comp = tr.records()
    assert (sub.name, sub.ticket, comp.parent, comp.ticket) == (
        "batcher.submit", 42, "batcher.submit", 42)


def test_no_records_while_off_and_unknown_names_refused():
    tr = Trace()
    for _ in range(3):
        with tr.span("executor.dispatch") as sp:
            pass
    tr.request(0.0, 0.1, 0.2, 0.3, ticket=1)
    assert tr.records() == [] and tr.dropped == 0
    assert tr.totals()["executor.dispatch"][0] == 3
    assert sp.seconds >= 0.0
    with pytest.raises(KeyError):
        tr.span("executor.nothing")


def test_record_cap_counts_drops():
    tr = Trace()
    tr.cap = 3
    tr.recording = True
    for _ in range(5):
        with tr.span("executor.gather"):
            pass
    assert len(tr.records()) == 3 and tr.dropped == 2
    assert tr.totals()["executor.gather"][0] == 5
    tr.clear()
    assert tr.records() == [] and tr.dropped == 0


def test_wave_times_keys_are_fixed():
    tr = Trace()
    keys = set(tr.wave_times())
    with tr.span("executor.fetch"):
        pass
    assert set(tr.wave_times()) == keys
    assert set(STAGE_MS) <= keys
    assert {f"span.{n}.n" for n in SPANS} <= keys


def test_threads_lose_no_update():
    tr = Trace()
    n_threads, n_spans = 8, 2000

    def work():
        for _ in range(n_spans):
            with tr.span("executor.dispatch"):
                with tr.span("executor.gather"):
                    pass
            tr.request(0.0, 0.0, 1.0, 2.0, ticket=0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    tot = tr.totals()
    for name in ("executor.dispatch", "executor.gather", "batcher.submit",
                 "planner.compile"):
        assert tot[name][0] == n_threads * n_spans, name
    assert tot["batcher.submit"][1] == pytest.approx(2.0 * n_threads
                                                     * n_spans)


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
def test_batcher_spans_count_every_wave(pipeline):
    """The pipelined batcher plans on one thread and dispatches and
    fetches on another: every stage still counts once a wave."""
    vecs, seqs = _corpus()
    eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(device="cpu",
                                                        T=10 ** 9))
    b = ContinuousBatcher(eng, max_wave=8, pipeline=pipeline)
    tr = eng.index.trace
    tr.recording = True
    n = 40
    try:
        for i in range(n):
            b.submit(Request(vector=vecs[i], pattern=PREDS[i % 4], k=5))
        assert len(b.drain(deadline_s=JOIN_S)) == n
    finally:
        b.close()
    tot = tr.totals()
    waves = n // 8
    for name in ("planner.plan", "executor.dispatch", "executor.fetch",
                 "batcher.respond"):
        assert tot[name][0] == waves, name
    # a pipelined drain also asks for a wave while the last is in flight
    assert tot["batcher.admit"][0] == tot["batcher.wave"][0] >= waves
    for name in ("batcher.submit", "planner.compile", "batcher.queue_wait"):
        assert tot[name][0] == n, name
    assert tot["batcher.queue_wait"][1] > 0.0
    assert tot["executor.residual"][0] == waves     # one LIKE a wave
    recs = tr.records()
    assert {r.ticket for r in recs if r.name == "batcher.submit"} == set(
        range(n))
    # every stage of a wave carries its index, on whichever thread
    dispatched = sorted(r.wave for r in recs
                        if r.name == "executor.dispatch")
    assert dispatched == list(range(waves))
    if pipeline:
        threads = {r.name: r.thread for r in recs}
        assert threads["planner.plan"] != threads["executor.dispatch"]
        assert tot["batcher.wait"][0] == waves


@pytest.fixture
def engine():
    vecs, seqs = _corpus()
    return RetrievalEngine(vecs, seqs, VectorMatonConfig(device="cpu",
                                                         T=10 ** 9))


def _waves(eng, n=3, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        q = rng.standard_normal((len(PREDS), DIM)).astype(np.float32)
        eng.query_batch(q, PREDS, 5)


def test_wave_times_equal_their_spans(engine):
    _waves(engine)
    rt = engine.index.runtime
    wt = rt.wave_times
    tot = {n: s * 1e3 for n, (_, s, _) in rt.trace.totals().items()}
    assert wt["plan_ms"] == tot["planner.plan"] > 0
    assert wt["upload_ms"] == tot["executor.scan_assemble"] > 0
    assert wt["launch_ms"] == pytest.approx(tot["executor.scan_launch"]
                                            + tot["executor.graphs"])
    assert wt["launch_ms"] > 0
    assert wt["merge_ms"] == pytest.approx(
        tot["executor.merge_dispatch"] + tot["executor.host_copies"]
        + tot["executor.assemble"])
    # no card: nothing to wait for, and the merge holds no wait
    assert wt["wait_ms"] == 0.0
    for key in STAGE_MS:
        assert wt[f"span.{STAGE_MS[key][0]}.ms"] == tot[STAGE_MS[key][0]]


def test_totals_survive_compact(engine):
    _waves(engine, n=2)
    before = engine.index.trace.totals()["executor.dispatch"][0]
    old_rt = engine.index.runtime
    engine.compact()
    rt = engine.index.runtime
    assert rt is not old_rt and rt.trace is engine.index.trace
    assert rt.trace.totals()["executor.dispatch"][0] == before == 2
    _waves(engine, n=2, seed=1)
    assert rt.wave_times["span.executor.dispatch.n"] == 4


def test_maintenance_stats_spans(engine):
    _waves(engine, n=2)
    st = engine.maintenance_stats()
    assert st["time_wait_ms"] == 0.0
    assert st["time_plan_ms"] == st["spans"]["planner.plan"]["ms"]
    d = st["spans"]["executor.dispatch"]
    assert d["n"] == 2 and 0.0 <= d["self_ms"] <= d["ms"]
    assert "executor.device_wait" not in st["spans"]     # never ran


def test_graph_spans_nest_under_executor_graphs():
    """A small graph index (T = 20): the fused beam's mask build, each
    size bucket's assembly and launch, shared and filtered."""
    vecs, seqs = _corpus(n=300)
    vm = VectorMaton(vecs, seqs, VectorMatonConfig(device="cpu", T=20,
                                                   quantize="none"))
    assert vm.runtime.graphs
    tr = vm.trace
    tr.recording = True
    q = np.random.default_rng(5).standard_normal((4, DIM)).astype(
        np.float32)
    vm.query_batch(q, ["a", "b", "a AND NOT b", "b AND c"], 5)
    recs = tr.records()
    parent = {}
    for r in recs:
        parent.setdefault(r.name, set()).add(r.parent)
    assert parent["executor.graphs"] == {"executor.dispatch"}
    for name in ("executor.graph_masks", "executor.graph_assemble",
                 "executor.graph_launch"):
        assert parent[name] == {"executor.graphs"}, name
    tot = tr.totals()
    assert tot["executor.graph_launch"][0] == tot[
        "executor.graph_assemble"][0] >= 2          # shared + filtered
    assert tot["executor.graphs"][2] <= tot["executor.graphs"][1]

"""The program's host spans as the benchmark reads them: the four span
metrics in a traced run, their readers on a program that keeps no spans,
the program's records on the profiler's clock, and a program span nested
in a harness span naming the device's idle gap."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from vmbench import devtrace, harness  # noqa: E402
from vmbench.tests.test_vmbench_runs import SEED, small  # noqa: E402

NEW = ("batcher.queue_wait_ms", "batcher.submit_us", "executor.host_ms",
       "executor.device_wait_ms")


@pytest.fixture(autouse=True)
def short_warmup(monkeypatch):
    monkeypatch.setattr(harness, "WARMUP_WAVES", 2)


def test_traced_run_reads_the_span_metrics(monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.3)
    res = harness.run_cell(small("sift1m-tags.bool"), SEED, 0.25,
                           trace=True, device="cpu", out=lambda **_: None,
                           import_guard=False)
    assert res["correct"]
    got = {n: res["metrics"][n]["value"] for n in NEW}
    for name in NEW[:3]:
        assert got[name] > 0, name
    # no card: fetch has no device work to wait for
    assert got["executor.device_wait_ms"] == 0.0
    assert res["metrics"]["executor.host_ms"]["unit"] == "ms/wave"
    # dispatch_ms times a part of the executor's host work
    assert got["executor.host_ms"] > res["metrics"][
        "executor.dispatch_ms"]["value"]


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_spans(name):
    """A program without the spans (the parent's) reports the old
    ``wave_times`` keys alone: the reader returns None, not an error."""
    run = harness.RunRecord(config={}, waves=10, answered=2560,
                            wave_times={"plan_ms": 7.0, "upload_ms": 3.0,
                                        "launch_ms": 5.0, "merge_ms": 9.0})
    assert harness.load_reader(name)(run) is None


def test_program_span_on_the_profiler_clock():
    """Program spans and ``record_function`` ranges opened around the
    same calls land within 50 us of each other (the median of five) once
    the host clock is mapped onto the trace's by the window's anchor, as
    ``read_profile`` maps it.  The first ``record_function`` of a process
    sets itself up for over a millisecond, which would delay the anchor
    taken inside it, so one runs first."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.trace import Trace
    tr = Trace()
    tr.recording = True
    with record_function("warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW_SPAN):
            anchor = time.perf_counter()
            for i in range(5):
                time.sleep(0.001)
                with record_function(f"probe{i}"):
                    with tr.span("executor.dispatch"):
                        time.sleep(0.002)
    ev = {e.name: e.time_range for e in prof.events()}
    off = ev[devtrace.WINDOW_SPAN].start - anchor * 1e6
    recs = tr.records()
    assert len(recs) == 5
    starts = sorted(abs(r.start * 1e6 + off - ev[f"probe{i}"].start)
                    for i, r in enumerate(recs))
    assert starts[2] < 50, starts
    for i, r in enumerate(recs):       # each span inside its range
        assert r.end * 1e6 + off < ev[f"probe{i}"].end + 50


class _Ev(SimpleNamespace):
    def __init__(self, name, t0, t1, cuda=False):
        import torch
        super().__init__(
            name=name, time_range=SimpleNamespace(start=t0, end=t1),
            device_type=(torch.autograd.DeviceType.CUDA if cuda
                         else torch.autograd.DeviceType.CPU),
            is_user_annotation=False)


def test_program_span_names_the_gap_inside_a_harness_span(monkeypatch):
    """The latest-opened open span names an idle gap: a program span
    inside ``engine.dispatch_batch`` takes the gap it covers, and the
    harness span keeps the rest."""
    from repro_torch.core import trace as trace_mod
    readings = [5.0003, 5.0006]
    monkeypatch.setattr(trace_mod, "perf_counter", lambda: readings.pop(0))
    tr = trace_mod.Trace()
    tr.recording = True
    with tr.span("executor.scan_assemble"):
        pass
    evs = [_Ev(devtrace.WINDOW_SPAN, 1000, 2000),
           _Ev("k", 1100, 1200, True), _Ev("k", 1800, 1900, True)]
    prof = SimpleNamespace(events=lambda: evs)
    spans = [("engine.dispatch_batch", 5.0, 5.0009)] + tr.spans()
    rec = devtrace.read_profile(prof, spans, 5.0, 0.001)
    idle = dict(rec.idle_gaps())
    # the program span, 1300-1600, is open at the middle of 1200-1800
    assert idle["executor.scan_assemble"] == pytest.approx(600e-6)
    assert idle["engine.dispatch_batch"] == pytest.approx(100e-6)
    assert idle["host"] == pytest.approx(100e-6)             # 1900-2000

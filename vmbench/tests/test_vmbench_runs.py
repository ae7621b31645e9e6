"""Whole runs of each cell at a size the CPU holds: a sound run comes out
correct, the control (the reference at TF32) does not, and neither does
a run whose timed path is broken underneath.

The check for a card is skipped (``run_cell`` is called with the
device); everything after it is the run's own path.  The faults a cell
of this benchmark can have: half of a wave's answers left out, a wave
that hands back the previous wave's answers (its state unchanged), and
one answer altered where it is produced.  No cell runs on more than one
chip, so no exchange between chips can be left out.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from vmbench import harness  # noqa: E402

CELLS = ["sift1m-tags.mix", "glove100-tags.mix", "sift1m-tags.bool"]
SEED = 2 ** 31 + 1234
ROWS = 2048


@pytest.fixture(autouse=True)
def short_warmup(monkeypatch):
    monkeypatch.setattr(harness, "WARMUP_WAVES", 2)


def small(name, rows=ROWS):
    """The cell at a size a test holds: fewer rows and a smaller loop;
    widths, metric, index settings and the mix as the cell has them."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, rows=rows,
                       batcher=dict(cell.config["batcher"], max_wave=16))
    cell.traffic = dict(cell.traffic, outstanding=48)
    return cell


def run(name, device="cpu", **kw):
    return harness.run_cell(small(name), SEED, 0.25, trace=False,
                            device=device, out=lambda **_: None,
                            import_guard=False, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    res = run(name, control=True)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"qps", "latency_p95_ms", "setup_s"}
    assert list(res)[-1] == "compared"
    ctl = res["control"]
    assert not ctl["correct"] and ctl["failed"] > 0
    # the control fails a limit that the program's readings sit well under
    for n in ("rank_gap", "dist_err"):
        assert res["compared"][n]["value"] < res["compared"][n]["limit"]
    assert max(ctl["numbers"][n][0] for n in ("rank_gap", "dist_err")) \
        > 3 * res["compared"]["dist_err"]["limit"]


def test_traced_run_reads_the_counter_metrics(monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.3)
    res = harness.run_cell(small("sift1m-tags.mix"), SEED, 0.25, trace=True,
                           device="cpu", out=lambda **_: None,
                           import_guard=False)
    assert res["correct"]
    got = res["metrics"]
    assert got["batcher.wave_requests"]["value"] == pytest.approx(16)
    assert got["planner.plan_ms"]["value"] > 0
    assert got["executor.dispatch_ms"]["value"] > 0
    assert "window_s" in res["device"] and "breakdown" in res


def _broken_fetch(monkeypatch, alter):
    from repro_torch.core.packed import PackedRuntime
    real = PackedRuntime.fetch
    state = {}

    def fetch(self, pending):
        out = real(self, pending)
        return alter(out, state)

    monkeypatch.setattr(PackedRuntime, "fetch", fetch)


def _drop_half(out, state):
    return [(d[:0], i[:0]) if r % 2 else (d, i)
            for r, (d, i) in enumerate(out)]


def _stale(out, state):
    prev = state.get("prev")
    state["prev"] = out
    return prev if prev is not None and len(prev) == len(out) else out


def _foreign_id(out, state):
    d, i = out[0]
    i = i.copy()
    i[-1] = (i[-1] + 1) % ROWS          # the next row: not the answer
    return [(d, i)] + out[1:]


def _nudged_distance(out, state):
    d, i = out[0]
    d = d.copy()
    d[0] += 0.01 * (abs(d[0]) + 1)       # well past the limit's 2e-5
    return [(d, i)] + out[1:]


@pytest.mark.parametrize("fault", [_drop_half, _stale, _foreign_id,
                                   _nudged_distance],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", ["sift1m-tags.mix", "glove100-tags.mix"])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _broken_fetch(monkeypatch, fault)
    res = run(name)
    assert not res["correct"] and res["failed"] > 0


def test_altered_kernel_output_is_not_correct(monkeypatch):
    """An answer altered where the scan kernel produces it."""
    from repro_torch.kernels import ops
    real = ops.topk_segmented_desc

    def kernel(*a, **kw):
        v, g = real(*a, **kw)
        v = v.clone()
        v[0, 0] += 1e-3 * float(v[0, 0].abs()) + 1e-3
        return v, g

    monkeypatch.setattr(ops, "topk_segmented_desc", kernel)
    res = run("glove100-tags.mix")
    assert not res["correct"]


@pytest.mark.parametrize("loaded", ["jax", "jaxlib.xla_client", "flax",
                                    "repro.core.packed"])
def test_result_withheld_when_jax_loads_after_the_window(
        monkeypatch, capsys, loaded):
    """A module that a metric reader or the reference loads once the
    window has closed still stops the result line."""
    def run_cell(*a, **kw):
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
        return {"correct": True, "compared": {}}

    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exit_:
        harness.main(["--workload", "sift1m-tags.mix", "--seed", "1",
                      "--seconds", "1"])
    assert exit_.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.gpu
def test_control_fails_on_the_card():
    """The control with the card's own TF32 products, at a small size."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = harness.run_cell(small("sift1m-tags.mix", rows=65536), SEED, 1.0,
                           trace=False, device="cuda", control=True,
                           out=lambda **_: None, import_guard=False)
    assert res["correct"], res["compared"]
    assert not res["control"]["correct"]
    assert np.isfinite(res["control"]["numbers"]["dist_err"][0])

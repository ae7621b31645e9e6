"""The yardstick on the CPU: the plain reference against the program's
``device="cpu"`` path on every predicate shape of the traffic mixes, the
predicate parser, the generators, the roofline count, the trace reader
and the import guard."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from vmbench import data, devtrace, guard, harness, reference  # noqa: E402
from vmbench import roofline  # noqa: E402

SIFT = json.loads((ROOT / "vmbench/configs/sift1m-tags.json").read_text())
GLOVE = json.loads((ROOT / "vmbench/configs/glove100-tags.json").read_text())
MIXES = [json.loads(p.read_text())
         for p in sorted((ROOT / "vmbench/traffic").glob("*.json"))]
PREDICATES = sorted({p for t in MIXES for p, _ in t["block"]})
ROWS = 3000
SEED = 2 ** 31 + 77


def _small(cfg, rows=ROWS):
    return dict(cfg, rows=rows)


@pytest.fixture(scope="module", params=["sift", "glove"])
def corpus(request):
    """A small table of each configuration, the program's index over it
    on the CPU, and queries."""
    from repro_torch.core.vectormaton import VectorMatonConfig
    from repro_torch.serve.engine import RetrievalEngine
    cfg = _small(SIFT if request.param == "sift" else GLOVE)
    inputs = harness.make_inputs(cfg, MIXES[0], SEED, "cpu")
    engine = RetrievalEngine(inputs.rows, inputs.sequences,
                             VectorMatonConfig(backend="torch", device="cpu",
                                               **cfg["index"]))
    return cfg, inputs, engine


@pytest.mark.parametrize("pred", PREDICATES)
def test_reference_matches_program(corpus, pred):
    cfg, inputs, engine = corpus
    metric = cfg["index"]["metric"]
    member = reference.Matcher(inputs.sequences).member(pred)
    from repro_torch.core.predicate import as_predicate
    want = np.array([as_predicate(pred).matches(s) for s in
                     inputs.sequences])
    assert (member == want).all()
    q = inputs.queries[:6]
    got = engine.index.query_batch(q, [pred] * len(q), 10)
    table = torch.from_numpy(inputs.rows)
    exact = reference.topk(table, np.nonzero(member)[0], q, 10, metric)
    ids = np.full((len(q), 10), -1, np.int64)
    dist = np.full((len(q), 10), np.nan)
    for r, (d, i) in enumerate(got):
        ids[r, :len(i)], dist[r, :len(d)] = i, d
    v = reference.judge_requests(
        table, q, np.zeros(len(q), np.int64), [member],
        reference.Answers(ids, dist), exact,
        float((table.double() ** 2).sum(1).max()), metric, cfg["limits"])
    assert v.correct, v.numbers
    # ids agree wherever the exact distances are not near ties
    for r in range(len(q)):
        gap = np.diff(exact.dist[r][exact.ids[r] >= 0])
        if len(gap) and gap.min() > 1e-3:
            assert list(ids[r]) == list(exact.ids[r])


@pytest.mark.parametrize("text,seq,want", [
    ("ab", "xaby", True), ("ab", "ba", False),
    ("LIKE 'a%c'", "abbc", True), ("LIKE 'a%c'", "abcd", False),
    ("LIKE '_b%'", "abz", True), ("LIKE '_b%'", "bz", False),
    ("LIKE 'a\\%'", "a%", True), ("LIKE 'a\\%'", "ab", False),
    ("NOT a AND b", "bz", True), ("NOT (a AND b)", "abz", False),
    ("a OR b AND c", "az", True), ("(a OR b) AND c", "az", False),
    ("CONTAINS 'it''s'", "it's", True), ("CONTAINS 'a b'", "a b", True),
])
def test_parser(text, seq, want):
    assert reference.matches(reference.parse(text), seq) is want


def test_generators_repeat_and_keep_sizes():
    cfg = _small(SIFT, 5000)
    a = harness.make_inputs(cfg, MIXES[0], SEED, "cpu")
    b = harness.make_inputs(cfg, MIXES[0], SEED, "cpu")
    c = harness.make_inputs(cfg, MIXES[0], SEED + 1, "cpu")
    assert (a.rows == b.rows).all() and a.sequences == b.sequences
    assert (a.queries == b.queries).all()
    assert a.rows.shape == c.rows.shape and not (a.rows == c.rows).all()
    assert a.sequences != c.sequences
    for j, (tag, share) in enumerate(cfg["tags"]):
        got = np.mean([tag in s for s in a.sequences])
        assert abs(got - share) < 4 * np.sqrt(share / len(a.sequences)) + 1e-3
    g = _small(GLOVE, 2000)
    rows, norms = data.make_rows(g, SEED, "cpu")
    assert np.allclose(np.linalg.norm(rows, axis=1), 1, atol=1e-5)
    q = data.make_queries(rows, norms, 64, 0.3, SEED)
    assert np.allclose(np.linalg.norm(q, axis=1), 1, atol=1e-5)


def test_schedule_blocks_hold_the_mix():
    t = MIXES[0]
    block = sum(c for _, c in t["block"])
    for seed in (1, 2 ** 31 + 5):
        s = data.Schedule(t, seed)
        picks = [s.next()[1] for _ in range(3 * block)]
        for b in range(3):
            got = np.bincount(picks[b * block:(b + 1) * block],
                              minlength=len(t["block"]))
            assert list(got) == [c for _, c in t["block"]]
    a = [data.Schedule(t, 1).next() for _ in range(5)]
    assert a == [data.Schedule(t, 1).next() for _ in range(5)]


def test_roofline_count_of_a_hand_made_wave():
    counts, sizes, d = {"a": 3, "e": 1}, {"a": 1000, "e": 20}, 128
    byts, ops = roofline.scan_work(counts, sizes, d, roofline.f32_row_bytes(d))
    assert byts == 1000 * 512 + 3 * 512 + 20 * 512 + 1 * 512
    assert ops == 2 * 128 * (3 * 1000 + 1 * 20)
    assert roofline.least_seconds(byts, ops, roofline.PEAK_F32) == max(
        byts / 3.35e12, ops / 67e12)
    b8, _ = roofline.scan_work(counts, sizes, d, roofline.sq8_row_bytes(d))
    assert b8 == 1000 * 136 + 3 * 512 + 20 * 136 + 512
    # the reader: one fp32 wave, one certified SQ8 wave (not counted)
    prof = devtrace.ProfileRecord(1.0, 0.5, {"topk_seg_f32_pass<1>": (
        2e-6, 1), "other": (1.0, 9)}, {})
    zero = {"batches": 0, "certified": 0, "escalations": 0, "fallbacks": 0}
    prof.waves = [{"counts": counts, "sq8": zero},
                  {"counts": counts, "sq8": dict(zero, batches=1,
                                                 certified=1)}]
    run = SimpleNamespace(profile=prof, sizes=sizes, config={"dim": d})
    share = harness.load_reader("kernel.scan_f32_roofline")(run)
    assert share == pytest.approx(
        100 * roofline.least_seconds(byts, ops, roofline.PEAK_F32) / 2e-6)
    run.profile = None
    assert harness.load_reader("kernel.scan_f32_roofline")(run) is None


def test_import_guard():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "repro", "repro.core.packed", "repro_torch",
              "repro_torch.core", "reprox", "numpy", "jaxtyping"]
    assert guard.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core.packed"]
    imps = guard.yardstick_imports()
    assert set(imps) == set(guard.yardstick_files())
    assert set(guard.YARDSTICK) < set(imps)
    assert "metrics/qps.py" in imps and "devtrace.py" in imps
    for mods in imps.values():
        assert "repro_torch" not in mods and "jax" not in mods


class _Ev:
    def __init__(self, name, t0, t1, cuda=False, note=False):
        self.name = name
        self.time_range = SimpleNamespace(start=t0, end=t1)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = note


def test_trace_reader_busy_and_idle_labels():
    evs = [_Ev(devtrace.WINDOW_SPAN, 1000, 2000),
           _Ev(devtrace.WINDOW_SPAN, 1001, 1999, cuda=True, note=True),
           _Ev("k1", 1100, 1300, True), _Ev("k2", 1200, 1400, True),
           _Ev("k1", 1800, 1900, True), _Ev("before", 0, 1050, True)]
    prof = SimpleNamespace(events=lambda: evs)
    anchor = 5.0                      # host seconds at the window's start
    spans = [("vmbench.run_wave", 5.0, 5.0009),
             ("engine.fetch_batch", 5.0005, 5.0007)]
    rec = devtrace.read_profile(prof, spans, anchor, 0.001)
    assert rec.window_s == pytest.approx(1e-3)
    # busy: 1000-1050, 1100-1400, 1800-1900 (the window clips 'before')
    assert rec.busy_s == pytest.approx(450e-6)
    assert rec.kernel_seconds(["k1"]) == pytest.approx(300e-6)
    idle = dict(rec.idle_gaps())
    assert idle["vmbench.run_wave"] == pytest.approx(50e-6)   # 1050-1100
    assert idle["engine.fetch_batch"] == pytest.approx(400e-6)  # 1400-1800
    assert idle["vmbench.run_wave"] + idle["engine.fetch_batch"] \
        + idle["host"] == pytest.approx(550e-6)

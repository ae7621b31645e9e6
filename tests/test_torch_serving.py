"""The serving tier of the port against the reference.

Every test of ``tests/test_engine.py`` (but the LM embedding),
``tests/test_pipeline.py`` and the batcher tests of
``tests/test_quant_and_batching.py`` has a counterpart here: the same
seeded inputs go through ``repro_torch`` (``device="cpu"``, the plain
PyTorch path) and through ``repro``.  Where the reference test was
parametrised over ``backend`` the counterpart is too: ``"device"`` runs
the reference's JAX executor beside the port's torch executor, ``"numpy"``
both packages' host oracle; elsewhere the device executors run.  Ids
must be equal and distances within atol 2e-4 / rtol 1e-4 (XLA and
PyTorch sum in different orders); where the reference holds a path
against its own oracle, the port's path is held against the port's
synchronous oracle, exactly.  Then the checkpoint format: checkpoints
cross between the packages in both directions, file for file, and
``python -m repro_torch.launch.serve`` runs end to end.  Tests marked
``gpu`` check the pinned staging ring and the per-wave fetch on the card.

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.  Every wait on a thread is bounded.
"""

import importlib
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.core.baselines import ground_truth, recall
from repro_torch.core.predicate import parse_predicate
from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
from repro_torch.data.corpora import SPECS, make_corpus, sample_patterns
from repro_torch.distributed import checkpoint as port_ckpt
from repro_torch.serve.batching import (ContinuousBatcher, DrainTimeout,
                                        RequestTimeout)
from repro_torch.serve.engine import Request, RetrievalEngine
from repro_torch.serve.pipeline import WaveJob
from repro_torch.serve.step import StagingRing, StagingStall

DIM = 12
ALPHA = "abcd"
PREDS = ["ab", "cd", "a", "ab AND cd", "ab OR cd", "NOT ab",
         "LIKE '%a%b%'", "ab AND NOT cd"]
BACKENDS = ["numpy", "device"]
JOIN_S = 60.0

PORT = types.SimpleNamespace(
    name="port", VectorMaton=VectorMaton, Config=VectorMatonConfig,
    Engine=RetrievalEngine, Request=Request, Batcher=ContinuousBatcher,
    DrainTimeout=DrainTimeout, RequestTimeout=RequestTimeout,
    WaveJob=WaveJob, StagingRing=StagingRing, StagingStall=StagingStall,
    parse_predicate=parse_predicate, ground_truth=ground_truth,
    recall=recall, make_corpus=make_corpus,
    sample_patterns=sample_patterns, SPECS=SPECS, ckpt=port_ckpt)


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    vm = imp("repro.core.vectormaton")
    bat = imp("repro.serve.batching")
    eng = imp("repro.serve.engine")
    base = imp("repro.core.baselines")
    corp = imp("repro.data.corpora")
    return types.SimpleNamespace(
        name="ref", VectorMaton=vm.VectorMaton, Config=vm.VectorMatonConfig,
        Engine=eng.RetrievalEngine, Request=eng.Request,
        Batcher=bat.ContinuousBatcher, DrainTimeout=bat.DrainTimeout,
        RequestTimeout=bat.RequestTimeout,
        WaveJob=imp("repro.serve.pipeline").WaveJob,
        StagingRing=imp("repro.serve.step").StagingRing,
        StagingStall=imp("repro.serve.step").StagingStall,
        parse_predicate=imp("repro.core.predicate").parse_predicate,
        ground_truth=base.ground_truth, recall=base.recall,
        make_corpus=corp.make_corpus, sample_patterns=corp.sample_patterns,
        SPECS=corp.SPECS, ckpt=imp("repro.distributed.checkpoint"))


def _config(pk, backend="device", **kw):
    """``device``: the reference's JAX executor / the port's torch
    executor on the CPU; ``numpy``: both packages' host oracle."""
    if pk is PORT:
        return pk.Config(backend="torch" if backend == "device"
                         else "numpy", device="cpu", **kw)
    return pk.Config(backend="jax" if backend == "device" else "numpy",
                     **kw)


def _mk(rng, n):
    seqs = ["".join(rng.choice(list(ALPHA), size=rng.integers(4, 12)))
            for _ in range(n)]
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    return vecs, seqs


def _engine(pk, backend="device", n=150, seed=0, **cfg):
    rng = np.random.default_rng(seed)
    vecs, seqs = _mk(rng, n)
    return pk.Engine(vecs, seqs, _config(pk, backend, T=20, M=8,
                                         ef_con=40, **cfg))


def _requests(pk, rng, count, tenants=1):
    return [pk.Request(vector=rng.standard_normal(DIM).astype(np.float32),
                       pattern=PREDS[i % len(PREDS)], k=5,
                       tenant="t%d" % (i % tenants))
            for i in range(count)]


def _snap(res, tickets):
    return {t: (res[t].ids.tolist(),
                np.round(res[t].distances, 5).tolist())
            for t in tickets}


def _agree(snap_ref, snap_port):
    """Two ticket -> (ids, distances) maps give the same answers."""
    assert snap_ref.keys() == snap_port.keys()
    for t in snap_ref:
        assert snap_ref[t][0] == snap_port[t][0], t
        np.testing.assert_allclose(snap_port[t][1], snap_ref[t][1],
                                   atol=2e-4, rtol=1e-4)


def _same(res_ref, res_port):
    """Two [(dists, ids)] lists give the same answers."""
    assert len(res_ref) == len(res_port)
    for (dr, ir), (dp, ip) in zip(res_ref, res_port):
        assert ir.tolist() == ip.tolist()
        np.testing.assert_allclose(dp, dr, atol=2e-4, rtol=1e-4)


def _both(ref, fn):
    return {pk.name: fn(pk) for pk in (ref, PORT)}


# --------------------------------------------------------------------- #
# tests/test_engine.py
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def engines(ref):
    """name -> (package, engine) over the same corpus, and its sequences."""
    out = {}
    for pk in (ref, PORT):
        vecs, seqs = pk.make_corpus("words", scale=0.2)
        out[pk.name] = (pk, pk.Engine(vecs, seqs, _config(pk, T=30, M=8,
                                                          ef_con=50)))
    return out, seqs


def _dim(engines):
    return engines[0]["port"][1].index.vectors.shape[1]


def _as_pairs(resps):
    return [(r.distances, r.ids) for r in resps]


def test_serve_batch_recall(engines):
    eng, seqs = engines
    pats = sample_patterns(seqs, 2, 40)
    vecs = np.random.default_rng(0).standard_normal(
        (len(pats), _dim(engines))).astype(np.float32)
    resps = {name: pe[1].serve_batch([pe[0].Request(vector=v, pattern=p,
                                                    k=10)
                                      for v, p in zip(vecs, pats)])
             for name, pe in eng.items()}
    port = eng["port"][1]
    recs = [recall(r.ids, ground_truth(port.index.vectors, port.index.esam,
                                       p, v, 10))
            for v, p, r in zip(vecs, pats, resps["port"])]
    assert np.mean(recs) >= 0.95
    assert all(r.latency_s < 2.0 for r in resps["port"])
    _same(_as_pairs(resps["ref"]), _as_pairs(resps["port"]))


def test_serve_batch_equals_per_request(engines):
    """Coalesced batched execution returns the (distance, id) results of
    serving the same requests one at a time — including repeated
    patterns and misses — and the reference's."""
    eng, seqs = engines
    pats = sample_patterns(seqs, 2, 10) + ["@@nope@@"]
    pats = [pats[i % len(pats)] for i in range(30)]
    vecs = np.random.default_rng(9).standard_normal(
        (len(pats), _dim(engines))).astype(np.float32)
    port = eng["port"][1]
    reqs = [Request(vector=v, pattern=p, k=8) for v, p in zip(vecs, pats)]
    assert port.index.plan(pats).coalesced >= 4
    batched = port.serve_batch(reqs)
    for req, resp in zip(reqs, batched):
        single = port.serve(req)
        assert np.array_equal(single.ids, resp.ids)
        np.testing.assert_allclose(single.distances, resp.distances,
                                   rtol=1e-6)
    pk, eng_r = eng["ref"]
    want = eng_r.serve_batch([pk.Request(vector=v, pattern=p, k=8)
                              for v, p in zip(vecs, pats)])
    _same(_as_pairs(want), _as_pairs(batched))


def test_serve_batch_mixed_k(engines):
    eng, seqs = engines
    pats = sample_patterns(seqs, 2, 4)
    vecs = np.random.default_rng(10).standard_normal(
        (len(pats), _dim(engines))).astype(np.float32)
    ks = [3 + (i % 2) * 5 for i in range(len(pats))]
    got = {}
    for name, (pk, e) in eng.items():
        reqs = [pk.Request(vector=v, pattern=p, k=k)
                for v, p, k in zip(vecs, pats, ks)]
        got[name] = e.serve_batch(reqs)
        for req, resp in zip(reqs, got[name]):
            assert len(resp.ids) <= req.k
            assert np.array_equal(e.serve(req).ids, resp.ids)
    _same(_as_pairs(got["ref"]), _as_pairs(got["port"]))


def test_corpora_shapes(ref):
    for name, spec in SPECS.items():
        vecs, seqs = make_corpus(name, scale=0.05)
        assert vecs.shape[1] == spec.dim
        assert len(vecs) == len(seqs)
        assert all(len(s) > 0 for s in seqs)
        assert set("".join(seqs[:10])) <= set(spec.alphabet)
        rv, rs = ref.make_corpus(name, scale=0.05)
        assert np.array_equal(rv, vecs) and rs == seqs


def test_engine_checkpoint_restore(engines, tmp_path):
    eng, seqs = engines
    port = eng["port"][1]
    path = str(tmp_path / "engine_ckpt")
    port.checkpoint(path)
    eng2 = RetrievalEngine.restore(path, device="cpu")
    assert eng2.index.config.device == "cpu"
    q = np.random.default_rng(1).standard_normal(_dim(engines)).astype(
        np.float32)
    p = sample_patterns(seqs, 2, 1)[0]
    d1, i1 = port.index.query(q, p, 5)
    d2, i2 = eng2.index.query(q, p, 5)
    assert np.array_equal(i1, i2)
    _same([eng["ref"][1].index.query(q, p, 5)], [(d2, i2)])


def test_engine_insert_then_query(engines):
    eng, seqs = engines
    v = np.random.default_rng(2).standard_normal(_dim(engines)).astype(
        np.float32)
    seen = {}
    for name, (pk, e) in eng.items():
        nid = e.insert(v, "zqzqzq")
        r = e.serve(pk.Request(vector=v, pattern="zqzq", k=3))
        assert nid in r.ids.tolist()
        e.delete(nid)
        r2 = e.serve(pk.Request(vector=v, pattern="zqzq", k=3))
        assert nid not in r2.ids.tolist()
        seen[name] = (nid, r.ids.tolist(), r2.ids.tolist())
    assert seen["ref"] == seen["port"]


# --------------------------------------------------------------------- #
# tests/test_pipeline.py: read / churn parity, replans
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_read_parity(ref, backend):
    """A pure-read stream through the pipelined batcher equals the
    synchronous oracle exactly in each package, and the two packages
    agree; the pipeline ran (waves counted, no replans)."""
    def run(pk):
        reqs = _requests(pk, np.random.default_rng(1), 48)
        outs = {}
        for mode in (False, True):
            b = pk.Batcher(_engine(pk, backend), budget=10 ** 9,
                           max_wave=8, pipeline=mode)
            try:
                tickets = [b.submit(r) for r in reqs]
                outs[mode] = _snap(b.drain(), tickets)
                if mode:
                    stats = b.maintenance_stats()
                    assert stats["pipeline_waves"] >= 6
                    assert stats["pipeline_replans"] == 0
                    assert "device_idle_ms" in stats
                    assert "planner_wait_ms" in stats
            finally:
                b.close()
        assert outs[False] == outs[True]
        return outs[True]

    out = _both(ref, run)
    _agree(out["ref"], out["port"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_churn_parity(ref, backend):
    """Inserts + deletes + compactions streamed through the pipelined
    batcher: write barriers + staleness replans keep every response
    exact against the synchronous loop over the same op script."""
    def run(pk):
        rng = np.random.default_rng(7)
        reqs = _requests(pk, rng, 40)
        ins = [(rng.standard_normal(DIM).astype(np.float32),
                "".join(rng.choice(list(ALPHA), size=8)))
               for _ in range(6)]
        outs = {}
        for mode in (False, True):
            b = pk.Batcher(_engine(pk, backend, auto_compact=False),
                           budget=10 ** 9, max_wave=4, pipeline=mode)
            try:
                tickets, wt = [], []
                for i, r in enumerate(reqs):
                    tickets.append(b.submit(r))
                    if i % 8 == 7 and i // 8 < len(ins):
                        wt.append(b.submit_insert(*ins[i // 8]))
                    if i == 19:
                        wt.append(b.submit_delete(3))
                    if i == 27:
                        wt.append(b.submit_compact())
                outs[mode] = _snap(b.drain(), tickets)
                assert all(t in b.write_results for t in wt)
            finally:
                b.close()
        assert outs[False] == outs[True]
        return outs[True]

    out = _both(ref, run)
    _agree(out["ref"], out["port"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_replan_on_generation_swap(ref, backend):
    """A write injected between a wave's plan and its dispatch is
    staleness-rejected and replanned, and the replanned results equal
    the oracle, which sees the same write before the same wave plans."""
    def run(pk):
        rng = np.random.default_rng(11)
        reqs = _requests(pk, rng, 24)
        wvec = rng.standard_normal(DIM).astype(np.float32)
        outs = {}
        for mode in (False, True):
            eng = _engine(pk, backend, auto_compact=False)
            b = pk.Batcher(eng, budget=10 ** 9, max_wave=6, pipeline=mode)
            fired = []

            def hook(idx, eng=eng, fired=fired):
                if idx == 2 and not fired:
                    fired.append(idx)
                    eng.insert(wvec, "abab")
                    eng.compact()

            b.on_wave_start = hook
            try:
                tickets = [b.submit(r) for r in reqs]
                outs[mode] = _snap(b.drain(), tickets)
                assert fired == [2]
                if mode:
                    assert b.maintenance_stats()["pipeline_replans"] >= 1
            finally:
                b.close()
        assert outs[False] == outs[True]
        return outs[True]

    out = _both(ref, run)
    _agree(out["ref"], out["port"])


def test_pipeline_replan_results_are_fresh(ref):
    """After a replan the answers include the inserted vector: the
    replanned wave executed against the new state."""
    def run(pk):
        rng = np.random.default_rng(3)
        eng = _engine(pk, n=60, auto_compact=False)
        b = pk.Batcher(eng, budget=10 ** 9, max_wave=4, pipeline=True)
        probe = rng.standard_normal(DIM).astype(np.float32)
        done = []

        def hook(idx):
            if idx == 1 and not done:
                done.append(idx)
                eng.insert(probe, "abab")

        b.on_wave_start = hook
        try:
            tickets = [b.submit(pk.Request(vector=probe, pattern="ab", k=3))
                       for _ in range(12)]
            res = b.drain()
        finally:
            b.close()
        assert b.maintenance_stats()["pipeline_replans"] >= 1
        new_id = len(eng.index.sequences) - 1
        for t in tickets[4:]:
            assert res[t].ids[0] == new_id
        return _snap(res, tickets)

    out = _both(ref, run)
    _agree(out["ref"], out["port"])


# --------------------------------------------------------------------- #
# thread safety
# --------------------------------------------------------------------- #

def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def test_concurrent_submitters_no_drops(ref):
    """8 submitter threads against one pipelined batcher: every ticket
    gets a response, each exact for its own request (against the port's
    synchronous oracle and the reference)."""
    eng = _engine(PORT, n=120)
    b = ContinuousBatcher(eng, budget=10 ** 9, max_wave=16, pipeline=True)
    seqs_snapshot = list(eng.index.sequences)
    n_threads, per = 8, 12
    tickets = [[] for _ in range(n_threads)]
    reqs = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def submitter(ti):
        trng = np.random.default_rng(100 + ti)
        barrier.wait(timeout=JOIN_S)
        for j in range(per):
            r = Request(vector=trng.standard_normal(DIM).astype(np.float32),
                        pattern=PREDS[(ti + j) % len(PREDS)], k=5,
                        tenant="t%d" % ti)
            reqs[ti].append(r)
            tickets[ti].append(b.submit(r))

    try:
        threads = [threading.Thread(target=submitter, args=(ti,))
                   for ti in range(n_threads)]
        for t in threads:
            t.start()
        _join(threads)
        res = b.drain()
    finally:
        b.close()
    assert len(res) == n_threads * per
    flat = [(r, tk) for ti in range(n_threads)
            for r, tk in zip(reqs[ti], tickets[ti])]
    q = np.stack([r.vector for r, _ in flat])
    pats = [r.pattern for r, _ in flat]
    want = _engine(ref, n=120).query_batch(q, pats, 5)
    for (r, tk), (wd, wi) in zip(flat, want):
        d, ids = eng.query_batch(r.vector[None, :], [r.pattern], r.k)[0]
        assert res[tk].ids.tolist() == ids.tolist()
        assert res[tk].ids.tolist() == wi.tolist()
        np.testing.assert_allclose(res[tk].distances, wd, atol=2e-4,
                                   rtol=1e-4)
        pred = parse_predicate(r.pattern)
        assert all(pred.matches(seqs_snapshot[i])
                   for i in res[tk].ids.tolist())


def test_concurrent_submit_with_writes_exact(ref):
    """Submitters race a writer thread: every read ticket answers, every
    write ticket resolves, and the final index equals the reference's
    after the same writes."""
    eng = _engine(PORT, n=100, seed=4)
    b = ContinuousBatcher(eng, budget=10 ** 9, max_wave=8, pipeline=True)
    wtickets, written = [], []

    def writer():
        wrng = np.random.default_rng(55)
        for _ in range(5):
            v = wrng.standard_normal(DIM).astype(np.float32)
            s = "".join(wrng.choice(list(ALPHA), size=6))
            written.append((v, s))
            wtickets.append(b.submit_insert(v, s))

    def reader(out):
        rrng = np.random.default_rng(66)
        for j in range(10):
            out.append(b.submit(Request(
                vector=rrng.standard_normal(DIM).astype(np.float32),
                pattern=PREDS[j % len(PREDS)], k=4)))

    rt1, rt2 = [], []
    try:
        ts = [threading.Thread(target=writer),
              threading.Thread(target=reader, args=(rt1,)),
              threading.Thread(target=reader, args=(rt2,))]
        for t in ts:
            t.start()
        _join(ts)
        res = b.drain()
    finally:
        b.close()
    for tk in rt1 + rt2:
        assert tk in res and len(res[tk].ids) > 0
    for wt in wtickets:
        assert wt in b.write_results
    ref_eng = _engine(ref, n=100, seed=4)
    for v, s in written:
        ref_eng.insert(v, s)
    q = np.random.default_rng(5).standard_normal(
        (len(PREDS), DIM)).astype(np.float32)
    _same(ref_eng.query_batch(q, PREDS, 4), eng.query_batch(q, PREDS, 4))


# --------------------------------------------------------------------- #
# tenant admission (weighted deficit round-robin)
# --------------------------------------------------------------------- #

def _rand_req(pk, rng, pattern, tenant="default", k=3):
    return pk.Request(vector=rng.standard_normal(DIM).astype(np.float32),
                      pattern=pattern, k=k, tenant=tenant)


def test_tenant_fairness_no_starvation(ref):
    """Tenant A floods 60 requests before tenant B's 6 arrive; DRR
    interleaves B into early waves, identically in both packages."""
    def run(pk):
        rng = np.random.default_rng(9)
        b = pk.Batcher(_engine(pk, n=100), budget=10 ** 9, max_wave=8,
                       pipeline=False)
        for _ in range(60):
            b.submit(_rand_req(pk, rng, "ab", "flood"))
        quiet = [b.submit(_rand_req(pk, rng, "cd", "quiet"))
                 for _ in range(6)]
        first_three, waves = [], []
        for _ in range(3):
            w = b.run_wave()
            waves.append(sorted(w))
            first_three.extend(w.keys())
        assert any(t in first_three for t in quiet)
        rest = b.drain()
        st = b.tenant_stats()
        assert st["quiet"]["served"] == 6
        assert st["flood"]["served"] == 60
        assert st["quiet"]["p50_ms"] >= 0.0
        return waves, _snap(rest, sorted(rest))

    out = _both(ref, run)
    assert out["ref"][0] == out["port"][0]
    _agree(out["ref"][1], out["port"][1])


def test_tenant_weights_shift_share(ref):
    """With weight 3:1 the heavy tenant takes a larger slice of each
    budget-bound wave, the same slice in both packages."""
    def run(pk):
        rng = np.random.default_rng(13)
        eng = _engine(pk, n=100)
        cost = eng.index.compile("a").est
        b = pk.Batcher(eng, budget=int(cost * 4.5), max_wave=64,
                       pipeline=False,
                       tenant_weights={"heavy": 3.0, "light": 1.0})
        for i in range(24):
            b.submit(_rand_req(pk, rng, "a",
                               "heavy" if i % 2 == 0 else "light"))
        wave = b.next_wave()
        heavy = sum(1 for q in wave if q.request.tenant == "heavy")
        light = sum(1 for q in wave if q.request.tenant == "light")
        assert heavy > light
        b.drain()
        assert b.pending() == 0
        return cost, [q.seq for q in wave]

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_single_tenant_admission_unchanged(ref):
    """One tenant: the strict-FIFO budget walk — stop at the first
    over-budget head, tick only that head."""
    def run(pk):
        rng = np.random.default_rng(2)
        eng = _engine(pk, n=80)
        cost = eng.index.compile("a").est
        b = pk.Batcher(eng, budget=int(cost * 2.5), max_wave=64,
                       pipeline=False)
        for _ in range(7):
            b.submit(_rand_req(pk, rng, "a"))
        w1 = b.next_wave()
        assert len(w1) == 2
        assert len(b._deferred) == 1
        w2 = b.next_wave()
        assert len(w2) == 2
        assert w2[0].seq == 2
        return cost, [q.seq for q in w1 + w2]

    out = _both(ref, run)
    assert out["ref"] == out["port"]


# --------------------------------------------------------------------- #
# drain bounds + staging ring
# --------------------------------------------------------------------- #

def test_drain_max_waves_raises(ref):
    def run(pk):
        rng = np.random.default_rng(21)
        b = pk.Batcher(_engine(pk, n=60), budget=1, max_wave=1,
                       max_defer=0, pipeline=False)
        for _ in range(30):
            b.submit(_rand_req(pk, rng, "a", k=2))
        with pytest.raises(pk.DrainTimeout):
            b.drain(max_waves=3)
        assert b.pending() == 27
        return b.pending()

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_drain_deadline_raises(ref):
    def run(pk):
        rng = np.random.default_rng(22)
        b = pk.Batcher(_engine(pk, n=60), budget=10 ** 9, max_wave=1,
                       pipeline=False)
        for _ in range(50):
            b.submit(_rand_req(pk, rng, "a", k=2))
        with pytest.raises(pk.DrainTimeout):
            b.drain(deadline_s=0.0)
        return True

    assert _both(ref, run) == {"ref": True, "port": True}


def test_drain_unbounded_still_completes(ref):
    def run(pk):
        rng = np.random.default_rng(24)
        b = pk.Batcher(_engine(pk, n=60), budget=10 ** 9, max_wave=4,
                       pipeline=True)
        try:
            tks = [b.submit(_rand_req(pk, rng, "ab", k=2))
                   for _ in range(10)]
            res = b.drain(max_waves=100, deadline_s=60.0)
        finally:
            b.close()
        assert all(t in res for t in tks)
        return _snap(res, tks)

    out = _both(ref, run)
    _agree(out["ref"], out["port"])


def test_staging_ring_reuse_and_growth(ref):
    def run(pk):
        ring = pk.StagingRing(dim=4, capacity=2, slots=2)
        a = ring.acquire(np.ones((2, 4), np.float32))
        bb = ring.acquire(np.full((5, 4), 2.0, np.float32))
        assert ring.grows == 1
        assert a.view().shape == (2, 4)
        assert bb.view().shape == (5, 4)
        assert float(bb.view()[0, 0]) == 2.0
        with pytest.raises(TimeoutError):
            ring.acquire(np.zeros((1, 4), np.float32), timeout=0.05)
        a.release()
        a.release()
        c = ring.acquire(np.zeros((1, 4), np.float32), timeout=1.0)
        assert c.view().shape == (1, 4)
        return (ring.grows, ring.waits, ring.stalls,
                np.array(bb.view()).tolist())

    out = _both(ref, run)
    assert out["ref"] == out["port"]
    ring = StagingRing(dim=4, capacity=2)
    slot = ring.acquire(np.ones((2, 4), np.float32))
    assert not slot.pinned and not slot.tensor().is_pinned()
    assert np.shares_memory(slot.view(), slot.tensor().numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_stage_api_matches_query_batch(ref, backend):
    """plan/dispatch/fetch composed manually equals query_batch."""
    def run(pk):
        rng = np.random.default_rng(31)
        eng = _engine(pk, backend, n=90)
        q = rng.standard_normal((6, DIM)).astype(np.float32)
        want = eng.query_batch(q, PREDS[:6], 4)
        got = eng.fetch_batch(eng.dispatch_batch(
            eng.plan_batch(q, PREDS[:6], 4)))
        for (d0, i0), (d1, i1) in zip(want, got):
            assert i0.tolist() == i1.tolist()
            np.testing.assert_allclose(d0, d1, rtol=1e-6)
        return got

    out = _both(ref, run)
    _same(out["ref"], out["port"])


def test_stale_wave_plan_rejected_at_dispatch(ref):
    """A write between plan_batch and dispatch_batch raises the
    staleness error; it does not serve a torn snapshot."""
    for pk in (ref, PORT):
        rng = np.random.default_rng(33)
        eng = _engine(pk, n=70, auto_compact=False)
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        wave = eng.plan_batch(q, ["ab", "cd"], 3)
        eng.insert(rng.standard_normal(DIM).astype(np.float32), "abcd")
        with pytest.raises(ValueError, match="stale plan"):
            eng.dispatch_batch(wave)


# --------------------------------------------------------------------- #
# typed deadline errors: RequestTimeout, StagingStall
# --------------------------------------------------------------------- #

def test_request_timeout_typed_and_counted(ref):
    """A wave that never delivers surfaces as a typed ``RequestTimeout``
    carrying the undelivered tickets, with the drop counted against the
    tenant."""
    def run(pk):
        rng = np.random.default_rng(0)
        b = pk.Batcher(_engine(pk), pipeline=False, request_timeout_s=0.05)
        try:
            t0 = b.submit(_rand_req(pk, rng, "ab", "slow"))
            t1 = b.submit(_rand_req(pk, rng, "cd", "slow"))
            items = b.next_wave()
            assert [q.seq for q in items] == [t0, t1]
            wedged = pk.WaveJob(queries=np.zeros((2, DIM), np.float32),
                                patterns=["ab", "cd"], k=3, ef_search=64)
            with pytest.raises(pk.RequestTimeout) as ei:
                b._collect_jobs([(wedged, items)], {})
            assert ei.value.tickets == [t0, t1]
            assert isinstance(ei.value, RuntimeError)
            st = b.tenant_stats()["slow"]
            assert st["dropped"] == 2 and st["served"] == 0
            return ei.value.tickets, st["dropped"]
        finally:
            b.close()

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_request_timeout_config_plumbs_through():
    b = ContinuousBatcher(_engine(PORT), request_timeout_s=7.5)
    try:
        assert b.request_timeout_s == 7.5
        assert "dropped" in next(iter(
            b.tenant_stats().values()), {"dropped": 0})
    finally:
        b.close()


def test_staging_stall_typed_with_diagnostics(ref):
    """All slots leased past the deadline -> typed ``StagingStall`` (a
    ``TimeoutError``) carrying the ring depth and the observed wait, and
    counted on the ring."""
    def run(pk):
        ring = pk.StagingRing(dim=4, slots=2)
        a = ring.acquire(np.zeros((1, 4), np.float32))
        b = ring.acquire(np.zeros((1, 4), np.float32))
        with pytest.raises(pk.StagingStall) as ei:
            ring.acquire(np.zeros((1, 4), np.float32), timeout=0.05)
        err = ei.value
        assert isinstance(err, TimeoutError)
        assert err.depth == 2 and err.wait_ms >= 50.0
        assert ring.stalls == 1
        assert "2 upload slots" in str(err)
        a.release()
        c = ring.acquire(np.zeros((1, 4), np.float32), timeout=0.05)
        c.release()
        b.release()
        return ring.stalls, err.depth

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_pipeline_error_path_releases_slot():
    """A wave whose dispatch raises returns its staging slot (after its
    guarded copies) and surfaces the error; the pipeline keeps
    serving."""
    eng = _engine(PORT, n=60)
    b = ContinuousBatcher(eng, budget=10 ** 9, max_wave=4, pipeline=True)
    rng = np.random.default_rng(8)

    def boom(idx):
        if idx == 0:
            raise RuntimeError("injected dispatch failure")

    b.on_wave_start = boom
    try:
        b.submit(_rand_req(PORT, rng, "ab"))
        with pytest.raises(RuntimeError, match="injected"):
            b.drain()
        b.on_wave_start = None
        tks = [b.submit(_rand_req(PORT, rng, "ab")) for _ in range(8)]
        res = b.drain()
        assert all(t in res for t in tks)
        assert sorted(b._pipe._ring._free) == [0, 1]
    finally:
        b.close()


# --------------------------------------------------------------------- #
# tests/test_quant_and_batching.py: the batcher
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def batchers(ref):
    """name -> (package, pipelined batcher) over the same corpus."""
    out = {}
    for pk in (ref, PORT):
        vecs, seqs = pk.make_corpus("words", scale=0.15)
        eng = pk.Engine(vecs, seqs, _config(pk, T=30, M=8, ef_con=40))
        out[pk.name] = (pk, pk.Batcher(eng, budget=2000, max_wave=8))
    yield out, vecs, seqs
    for _, b in out.values():
        b.close()


def test_batcher_serves_all_correctly(batchers):
    bs, vecs, seqs = batchers
    pats = sample_patterns(seqs, 2, 30)
    qs = np.random.default_rng(1).standard_normal(
        (len(pats), vecs.shape[1])).astype(np.float32)
    snaps = {}
    for name, (pk, b) in bs.items():
        tickets = [b.submit(pk.Request(vector=q, pattern=p, k=5))
                   for q, p in zip(qs, pats)]
        out = b.drain()
        assert set(out) == set(tickets)
        snaps[name] = _snap(out, tickets)
    b = bs["port"][1]
    for tid, q, p in zip(snaps["port"], qs, pats):
        gt = ground_truth(b.engine.index.vectors, b.engine.index.esam,
                          p, q, 5)
        assert recall(np.asarray(snaps["port"][tid][0]), gt) >= 0.8
    _agree(snaps["ref"], snaps["port"])


def test_batcher_no_starvation(batchers):
    bs, vecs, seqs = batchers
    pats = sample_patterns(seqs, 1, 1) + sample_patterns(seqs, 4, 20)
    qs = np.random.default_rng(2).standard_normal(
        (len(pats), vecs.shape[1])).astype(np.float32)
    waves_of = {}
    for name, (pk, b) in bs.items():
        for q, p in zip(qs, pats):
            b.submit(pk.Request(vector=q, pattern=p, k=5))
        waves, served = 0, {}
        while b.pending() and waves < 2 + b.max_defer + 21:
            served.update(b.run_wave())
            waves += 1
        assert not b.pending(), "starved requests remain"
        waves_of[name] = (waves, _snap(served, sorted(served)))
    assert waves_of["ref"][0] == waves_of["port"][0]
    _agree(waves_of["ref"][1], waves_of["port"][1])


def test_batcher_budget_limits_wave(batchers):
    bs, vecs, seqs = batchers
    pats = sample_patterns(seqs, 1, 12)
    qs = np.random.default_rng(3).standard_normal(
        (len(pats), vecs.shape[1])).astype(np.float32)
    seqs_of = {}
    for name, (pk, b) in bs.items():
        for q, p in zip(qs, pats):
            b.submit(pk.Request(vector=q, pattern=p, k=5))
        wave = b.next_wave()
        assert 1 <= len(wave) <= b.max_wave
        seqs_of[name] = [(q.seq, q.cost) for q in wave]
        b._queue.clear()
        b._deferred.clear()
    assert seqs_of["ref"] == seqs_of["port"]


def test_batcher_deep_backlog_keeps_budget_discipline(batchers):
    """With a deep backlog, admission stops at the first over-budget
    request, keeping every wave at about the budget."""
    bs, vecs, seqs = batchers
    pat = sample_patterns(seqs, 1, 1)[0]
    sizes = {}
    for name, (pk, b) in bs.items():
        rng = np.random.default_rng(4)
        cost = b.engine.index.compile(pat).est
        assert cost > 0
        deep = 6 * b.max_defer
        for _ in range(deep):
            b.submit(pk.Request(vector=rng.standard_normal(vecs.shape[1])
                                .astype(np.float32), pattern=pat, k=5))
        per_wave = max(1, b.budget // cost)
        waves, lens = 0, []
        while b.pending() and waves < 4 * deep:
            wave = b.next_wave()
            assert wave, "no progress"
            spent = sum(q.cost for q in wave)
            assert len(wave) <= per_wave + 1, (len(wave), per_wave)
            assert spent <= b.budget + cost, (spent, b.budget)
            lens.append(len(wave))
            waves += 1
        assert not b.pending()
        assert len(b._deferred) <= 1
        b._deferred.clear()
        sizes[name] = (cost, lens)
    assert sizes["ref"] == sizes["port"]


# --------------------------------------------------------------------- #
# checkpoints across packages
# --------------------------------------------------------------------- #

SCHEMA = {"genre": "tag", "price": "numeric"}
CK_PREDS = PREDS + ["genre = 'rock'", "a AND price < 5",
                    "(genre = 'jazz' OR b) AND NOT cd"]


def _churned(pk, quantize, seed=5, n=160):
    """An index taken mid-delta: graph states, inserts past the upload
    watermark, tombstones (some inside graphs) and a schema."""
    rng = np.random.default_rng(seed)
    vecs, seqs = _mk(rng, n)
    attrs = [{"genre": ("rock", "jazz", "pop")[i % 3], "price": float(i % 9)}
             for i in range(n)]
    vm = pk.VectorMaton(vecs, seqs, _config(
        pk, T=20, M=8, ef_con=40, quantize=quantize, auto_compact=False,
        schema=SCHEMA), attributes=attrs)
    vm.query_batch(rng.standard_normal((2, DIM)).astype(np.float32),
                   ["a", "b"], 4)                       # upload the table
    for j in range(12):
        vm.insert(rng.standard_normal(DIM).astype(np.float32),
                  "".join(rng.choice(list(ALPHA), size=7)),
                  attributes={"genre": "rock", "price": float(j)})
    for vid in (3, 17, 42, 90, 161):
        vm.delete(vid)
    assert vm.maintenance_stats()["delta_pending"] == 12
    assert len(vm.runtime.graphs) > 0
    return vm


def _reload_ref(ref, path):
    back = ref.ckpt.load_vectormaton(ref.VectorMaton, path)
    back.config.backend = "jax"         # the reference loads on numpy
    back._refresh_runtime()
    return back


def _ck_queries(seed=6):
    return np.random.default_rng(seed).standard_normal(
        (len(CK_PREDS), DIM)).astype(np.float32)


@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_reference_checkpoint_loads_in_port(ref, tmp_path, quantize):
    """A reference checkpoint taken mid-delta (tombstones, graph states,
    a schema, a sidecar) loads in the port and answers like the
    reference's own restore."""
    vm_r = _churned(ref, quantize)
    path = str(tmp_path / "ref_ckpt")
    ref.ckpt.save_vectormaton(vm_r, path, extra_meta={"lsn": 17})
    back_r = _reload_ref(ref, path)
    back_t = port_ckpt.load_vectormaton(VectorMaton, path, device="cpu")
    assert port_ckpt.load_checkpoint_meta(path) == {"lsn": 17}
    assert back_t.deleted == back_r.deleted == vm_r.deleted
    assert back_t.config.quantize == quantize
    assert back_t.config.schema == SCHEMA
    assert back_t.config.backend == "torch"
    assert len(back_t.runtime.graphs) == len(back_r.runtime.graphs) > 0
    q = _ck_queries()
    _same(back_r.query_batch(q, CK_PREDS, 6),
          back_t.query_batch(q, CK_PREDS, 6))
    assert back_t.maintenance_stats()["generation"] == \
        back_r.maintenance_stats()["generation"] == \
        vm_r.maintenance_stats()["generation"] + 1


@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_port_checkpoint_loads_in_reference(ref, tmp_path, quantize):
    """A port checkpoint taken mid-delta loads in the reference's loader
    and answers like the port, before and after its own restore."""
    vm_t = _churned(PORT, quantize)
    q = _ck_queries()
    live = vm_t.query_batch(q, CK_PREDS, 6)
    path = str(tmp_path / "port_ckpt")
    vm_t.save(path, extra_meta={"lsn": 3})
    back_r = _reload_ref(ref, path)
    assert ref.ckpt.load_checkpoint_meta(path) == {"lsn": 3}
    assert back_r.deleted == vm_t.deleted
    assert back_r.config.quantize == quantize
    assert back_r.config.schema == SCHEMA
    back_t = VectorMaton.load(path, device="cpu")
    _same(back_r.query_batch(q, CK_PREDS, 6), live)
    _same(back_r.query_batch(q, CK_PREDS, 6),
          back_t.query_batch(q, CK_PREDS, 6))
    assert back_t.maintenance_stats()["generation"] == \
        back_r.maintenance_stats()["generation"] == \
        vm_t.maintenance_stats()["generation"] + 1


@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_checkpoint_files_match_reference(ref, tmp_path, quantize):
    """The same index churned in both packages writes the same files,
    array names, dtypes and contents."""
    paths = {}
    for pk in (ref, PORT):
        paths[pk.name] = str(tmp_path / pk.name)
        pk.ckpt.save_vectormaton(_churned(pk, quantize), paths[pk.name])
    files = sorted(os.listdir(paths["ref"]))
    assert files == sorted(os.listdir(paths["port"]))
    assert any(f.startswith("graph_") for f in files)
    for f in files:
        a, b = (os.path.join(paths[s], f) for s in ("ref", "port"))
        if f.endswith(".npz"):
            za, zb = (np.load(x, allow_pickle=True) for x in (a, b))
            assert sorted(za.files) == sorted(zb.files), f
            pairs = [(za[k], zb[k]) for k in za.files]
        else:
            pairs = [(np.load(a, allow_pickle=True),
                      np.load(b, allow_pickle=True))]
        for xa, xb in pairs:
            assert xa.dtype == xb.dtype and xa.shape == xb.shape, f
            assert xa.tolist() == xb.tolist(), f


def test_launch_serve_cli(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu`` builds, serves
    a batch at full recall and checkpoints."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    ck = str(tmp_path / "cli_ckpt")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--corpus", "words", "--scale", "0.1", "--queries", "20",
         "--checkpoint", ck],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "device=cpu" in out.stdout
    assert "mean recall@10 1.000" in out.stdout
    back = RetrievalEngine.restore(ck, device="cpu")
    assert len(back.index.vectors) == 200


def test_serving_defaults_to_card_and_refuses_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs, seqs = _mk(np.random.default_rng(0), 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalEngine(vecs, seqs)
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalEngine(vecs, seqs, _config(PORT),
                        mesh=make_host_mesh(data=2))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--corpus", "words", "--scale", "0.05",
                    "--queries", "2"])


# --------------------------------------------------------------------- #
# on the card: pinned staging, per-wave fetch
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_pinned_ring_reuse_is_exact(cuda):
    """A pipelined stream over a two-slot pinned ring: every wave equals
    the synchronous oracle, though each slot is refilled while the
    other's upload may still be in flight."""
    rng = np.random.default_rng(40)
    vecs, seqs = _mk(rng, 3000)
    cfg = dict(T=10 ** 9, quantize="none")
    reqs = [Request(vector=rng.standard_normal(DIM).astype(np.float32),
                    pattern=PREDS[i % len(PREDS)], k=5) for i in range(256)]
    outs = {}
    for mode in (False, True):
        eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(**cfg))
        b = ContinuousBatcher(eng, budget=10 ** 9, max_wave=8,
                              pipeline=mode)
        try:
            tickets = [b.submit(r) for r in reqs]
            outs[mode] = _snap(b.drain(), tickets)
            if mode:
                assert b._pipe._ring.pin
                assert all(buf.is_pinned() for buf in b._pipe._ring._bufs)
        finally:
            b.close()
    assert outs[False] == outs[True]


@pytest.mark.gpu
def test_gpu_fetch_waits_for_its_own_wave_only(cuda):
    """Dispatch wave N, then N+1, then a long kernel: fetching N (and
    N+1) returns while that later kernel still runs, with the answers of
    the synchronous path."""
    rng = np.random.default_rng(41)
    vecs, seqs = _mk(rng, 2000)
    eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(
        T=10 ** 9, quantize="none"))
    qs = [rng.standard_normal((8, DIM)).astype(np.float32) for _ in range(2)]
    want = [eng.query_batch(q, PREDS, 5) for q in qs]
    pend = [eng.dispatch_batch(eng.plan_batch(q, PREDS, 5)) for q in qs]
    torch.cuda._sleep(2_000_000_000)            # about a second of spin
    later = torch.cuda.Event()
    later.record()
    got = [eng.fetch_batch(p) for p in pend]
    assert not later.query(), "fetch waited for work queued after it"
    for p in pend:
        assert p.inner.ready is not None and p.inner.ready.query()
        assert all(h.is_pinned() for pair in p.inner.host_launches.values()
                   for h in pair)
    later.synchronize()
    for w, g in zip(want, got):
        for (dw, iw), (dg, ig) in zip(w, g):
            assert iw.tolist() == ig.tolist()
            assert np.array_equal(dw, dg)

"""End-to-end gates of the port that need no LM, beside the reference.

* The batched-engine smoke workload of ``scripts/ci.sh`` (120 records,
  ``T=20`` so graph states exist, ten requests of plain patterns and
  boolean predicates, k = 5) runs through the port's ``RetrievalEngine``
  under ``sq8`` and ``none``: frozen, mid-delta (inserts and deletes)
  and after a compaction.  Its own checks hold on every wave — each
  batched answer equals the same request served alone, and every id
  satisfies its predicate.  Without a mesh the answers equal the
  reference's JAX executor's (``backend="jax"``): same ids, distances
  within atol 2e-4 / rtol 1e-4.  With a 4-shard CPU mesh every request is
  an exact scan over its qualified set, so the answers equal brute force,
  and the reference's wherever no graph state answers the request.
* The ``examples/quickstart.py`` flow — build, query four patterns with
  recall against the exact answer, insert, find, delete — runs through
  ``repro_torch`` beside ``repro`` on the host oracle and on the device
  executors.

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import types

import numpy as np
import pytest

from repro_torch.core.baselines import ground_truth, recall
from repro_torch.core.predicate import parse_predicate
from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.engine import Request, RetrievalEngine

PORT = types.SimpleNamespace(
    name="port", VectorMaton=VectorMaton, Config=VectorMatonConfig,
    Engine=RetrievalEngine, Request=Request, ground_truth=ground_truth,
    recall=recall)
CI_PATTERNS = ["ab", "ab", "ab", "ab", "cd", "a", "ab AND cd", "ab OR cd",
               "NOT ab", "LIKE '%a%b%'"]


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    vm = imp("repro.core.vectormaton")
    eng = imp("repro.serve.engine")
    base = imp("repro.core.baselines")
    return types.SimpleNamespace(
        name="ref", VectorMaton=vm.VectorMaton, Config=vm.VectorMatonConfig,
        Engine=eng.RetrievalEngine, Request=eng.Request,
        ground_truth=base.ground_truth, recall=base.recall, cache={})


def _config(pk, backend, **kw):
    """``device``: the reference's JAX executor / the port's torch
    executor on the CPU; ``numpy``: both packages' host oracle."""
    if pk is PORT:
        return pk.Config(backend="torch" if backend == "device"
                         else "numpy", device="cpu", **kw)
    return pk.Config(backend="jax" if backend == "device" else "numpy",
                     **kw)


# --------------------------------------------------------------------- #
# the batched-engine smoke of scripts/ci.sh
# --------------------------------------------------------------------- #

def ci_workload(pk, quantize, mesh=None):
    """The ``scripts/ci.sh`` engine smoke, then a write burst and a
    compaction: the engine and per phase the requests, the answers and
    the brute-force answers at that point."""
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("abcd"), size=rng.integers(5, 14)))
            for _ in range(120)]
    vecs = rng.standard_normal((120, 16)).astype(np.float32)
    eng = pk.Engine(vecs, seqs, _config(
        pk, "device", T=20, M=8, ef_con=40, quantize=quantize,
        auto_compact=False), **({} if mesh is None else {"mesh": mesh}))
    phases = []

    def wave(name):
        reqs = [pk.Request(vector=rng.standard_normal(16).astype(
            np.float32), pattern=p, k=5) for p in CI_PATTERNS]
        exact = [_brute(eng.index, r.pattern, r.vector, 5) for r in reqs]
        phases.append((name, reqs, eng.serve_batch(reqs), exact))

    wave("frozen")
    for _ in range(6):
        eng.insert(rng.standard_normal(16).astype(np.float32),
                   "".join(rng.choice(list("abcd"), size=7)))
    for gid in (4, 40, 121):
        eng.delete(gid)
    wave("mid_delta")
    eng.compact()
    wave("compacted")
    return eng, phases


def _ci_checks(eng, phases):
    """``scripts/ci.sh``'s assertions: batched equals single, and every
    id satisfies its predicate."""
    seqs = eng.index.sequences
    for name, reqs, resps, _ in phases[-1:]:
        for req, resp in zip(reqs, resps):
            single = eng.serve(req)
            assert np.array_equal(single.ids, resp.ids), (name, req.pattern)
    for name, reqs, resps, _ in phases:
        for req, resp in zip(reqs, resps):
            pred = parse_predicate(req.pattern)
            assert all(pred.matches(seqs[i]) for i in resp.ids.tolist()), \
                (name, req.pattern)


def _brute(vm, ptext, q, k):
    pred = parse_predicate(ptext)
    ids = np.asarray([j for j, s in enumerate(vm.sequences)
                      if j not in vm.deleted and pred.matches(s)],
                     dtype=np.int64)
    if not len(ids):
        return []
    dd = ((q[None, :] - vm.vectors[ids]) ** 2).sum(-1)
    return ids[np.argsort(dd, kind="stable")[:k]].tolist()


def _graph_free(vm, patterns):
    plan = vm.plan(patterns)
    free = set(range(len(patterns))) - set(plan.misses)
    for e in plan.entries:
        if any(s.graph_states for s in e.sources):
            free -= set(e.requests)
    return free


def _reference_phases(ref, quantize):
    if quantize not in ref.cache:
        ref.cache[quantize] = ci_workload(ref, quantize)[1]
    return ref.cache[quantize]


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_ci_engine_smoke_beside_reference(ref, quantize, shards):
    mesh = (None if shards is None
            else make_host_mesh(data=shards, device="cpu"))
    eng, phases = ci_workload(PORT, quantize, mesh)
    _ci_checks(eng, phases)
    want = _reference_phases(ref, quantize)
    assert [p[0] for p in phases] == [p[0] for p in want]
    for (name, reqs, got, exact), (_, _, exp, _) in zip(phases, want):
        if mesh is None:
            free = range(len(reqs))
        else:
            free = _graph_free(eng.index, CI_PATTERNS)
            assert [r.ids.tolist() for r in got] == exact, name
        for r in free:
            assert got[r].ids.tolist() == exp[r].ids.tolist(), (name, r)
            np.testing.assert_allclose(got[r].distances, exp[r].distances,
                                       atol=2e-4, rtol=1e-4)
    if mesh is not None:
        st = eng.index.snapshot().traffic
        assert st["shard_batches"] > 0 and st["shard_mask_bytes"] == 0


# --------------------------------------------------------------------- #
# the quickstart flow
# --------------------------------------------------------------------- #

def quickstart(pk, backend):
    """``examples/quickstart.py`` with its prints turned into results."""
    rng = np.random.default_rng(0)
    sequences = ["banana", "nana", "na", "a", "bandana", "canal", "anagram",
                 "cabana"]
    vectors = rng.standard_normal((len(sequences), 16)).astype(np.float32)
    index = pk.VectorMaton(vectors, sequences,
                           _config(pk, backend, T=4, M=8, ef_con=32))
    out = {"stats": index.stats()}
    query_vec = vectors[1] + 0.1 * rng.standard_normal(16).astype(
        np.float32)
    for pattern in ["ana", "nd", "gram", "xyz"]:
        dists, ids = index.query(query_vec, pattern, k=3)
        gt = pk.ground_truth(vectors, index.esam, pattern, query_vec, 3)
        out[pattern] = (np.asarray(dists), ids.tolist(),
                        [sequences[i] for i in ids],
                        pk.recall(ids, gt))
    new_id = index.insert(rng.standard_normal(16).astype(np.float32),
                          "banal")
    _, ids = index.query(index.vectors[new_id], "ban", k=2)
    assert new_id in ids.tolist()
    out["inserted"] = (new_id, ids.tolist())
    index.delete(new_id)
    _, ids = index.query(index.vectors[new_id], "ban", k=2)
    assert new_id not in ids.tolist()
    out["deleted"] = ids.tolist()
    return out


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_quickstart_flow_beside_reference(ref, backend):
    got = quickstart(PORT, backend)
    want = quickstart(ref, backend)
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(got[key], tuple) and key not in ("inserted",):
            (dg, *rest_g), (dw, *rest_w) = got[key], want[key]
            assert rest_g == rest_w, key
            np.testing.assert_allclose(dg, dw, atol=2e-4, rtol=1e-4)
        else:
            assert got[key] == want[key], key
    assert got["gram"][2] == ["anagram"] and got["xyz"][1] == []

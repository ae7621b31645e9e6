"""The sharded executor of the port against the reference.

``repro_torch.distributed.sharded_search`` serves a ``QueryPlan`` over
the row shards of a ``launch.mesh.Mesh``; here every mesh is on the CPU,
where each shard's sweep runs the plain versions of kernels A and B.

* **Held to the reference.**  One child process with eight XLA host
  devices runs the reference's sharded cases — ``sharded_topk`` (exact,
  masked, non-divisible N with its sentinels), ``sharded_plan_topk`` over
  chain descriptors, tails, partial attribute ranges and residuals under
  ``sq8`` and ``none`` (frozen, mid-delta cold and warm, compacted), the
  engine over a mesh and a checkpoint restored
  from 8 onto 4 shards — and writes their answers and counters to an
  ``.npz``.  The same functions, on the same numpy-seeded inputs, run
  through the port on ``make_host_mesh(data=8, device="cpu")``: equal
  ids, distances within 1e-5·max|d|, equal ``(+inf, -1)`` sentinels,
  ``sq8_stats``, sharded launch counts and ``shard_*`` counters.  The
  reference's sharded path cannot take a resident delete after its
  residency was built, so its cases delete before the build or past the
  watermark only.
* **Held to brute force** where the reference fails: deletes after the
  residency was built, and the descriptor churn scenario of
  ``tests/test_distributed.py::test_sharded_plan_descriptor_churn_exact``.
* **Held to the port's own paths:** the dense-mask oracle, 1, 2, 3 and 8
  shards against the single-device ``query_batch``, the SQ8 escalation
  and streak policy, the cross-shard fold's tie rule against
  ``lax.top_k``, the pipelined batcher and a replica resharded on
  rejoin.  Tests marked ``gpu`` repeat the
  comparisons on the card.

The reference is imported inside functions, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.core.predicate import parse_predicate
from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
from repro_torch.distributed import replication as port_repl
from repro_torch.distributed import sharded_search as port_ss
from repro_torch.distributed.elastic import ElasticPlan
from repro_torch.kernels import distance_topk, ops, quant
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.serve.batching import ContinuousBatcher
from repro_torch.serve.engine import Request, RetrievalEngine

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
GENRES = ["rock", "jazz", "pop"]
SCHEMA = {"genre": "tag", "price": "numeric"}
PREDS = ["a", "ab", "ab AND cd", "NOT ab", "LIKE '%a%b%'", "a OR cd", "ab",
         "genre = 'rock'", "price >= 3 AND price <= 12", "price < 2.5",
         "ab AND genre = 'jazz'", "LIKE '%a%b%' AND price < 10",
         "genre = 'pop' OR cd", "NOT genre = 'rock' AND a"]
COUNTERS = ("shard_batches", "shard_mask_bytes", "shard_descriptor_bytes",
            "shard_tail_bytes", "shard_query_bytes", "bytes_to_device")


# --------------------------------------------------------------------- #
# the two packages behind one namespace
# --------------------------------------------------------------------- #

def port_ns(device="cpu"):
    return types.SimpleNamespace(
        name="port", VectorMaton=VectorMaton,
        Config=lambda **kw: VectorMatonConfig(device=device, **kw),
        Engine=RetrievalEngine, Request=Request,
        restore=lambda path, mesh: RetrievalEngine.restore(
            path, mesh=mesh, device=device),
        mesh=lambda data: make_host_mesh(data=data, device=device),
        devices=lambda mesh, count: mesh.devices.flat[:count],
        sharded_topk=port_ss.sharded_topk,
        sharded_plan_topk=port_ss.sharded_plan_topk,
        ElasticPlan=ElasticPlan, ops=ops,
        arr=lambda t: t.cpu().numpy())


def ref_ns():
    imp = importlib.import_module
    jax = imp("jax")
    jnp = imp("jax.numpy")
    vm = imp("repro.core.vectormaton")
    eng = imp("repro.serve.engine")
    ss = imp("repro.distributed.sharded_search")

    def sharded_topk(mesh, q, base, k, valid_mask=None):
        return ss.sharded_topk(
            mesh, jnp.asarray(q), jnp.asarray(base), k,
            valid_mask=(None if valid_mask is None
                        else jnp.asarray(valid_mask)))

    return types.SimpleNamespace(
        name="ref", VectorMaton=vm.VectorMaton, Config=vm.VectorMatonConfig,
        Engine=eng.RetrievalEngine, Request=eng.Request,
        restore=lambda path, mesh: eng.RetrievalEngine.restore(
            path, mesh=mesh),
        mesh=lambda data: imp("repro.launch.mesh").make_host_mesh(
            data=data, model=1),
        devices=lambda mesh, count: jax.devices()[:count],
        sharded_topk=sharded_topk, sharded_plan_topk=ss.sharded_plan_topk,
        ElasticPlan=imp("repro.distributed.elastic").ElasticPlan,
        ops=imp("repro.kernels.ops"), arr=np.asarray)


# --------------------------------------------------------------------- #
# the cases: each writes named arrays into ``out``
# --------------------------------------------------------------------- #

def _put_results(out, tag, res):
    for r, (d, i) in enumerate(res):
        out[f"{tag}/{r}/d"] = np.asarray(d, np.float32)
        out[f"{tag}/{r}/i"] = np.asarray(i, np.int64)


def _records(rng, n, dim, attributes=True):
    seqs = ["".join(rng.choice(list("abcd"), size=rng.integers(5, 14)))
            for _ in range(n)]
    attrs = [{"genre": GENRES[int(rng.integers(0, 3))],
              "price": float(np.round(rng.uniform(0, 20), 2))}
             for _ in range(n)]
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return vecs, seqs, (attrs if attributes else None)


def case_topk(pk, out):
    """``sharded_topk``: exact, masked, non-divisible N and sentinels."""
    mesh = pk.mesh(8)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((4096, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    d, i = pk.sharded_topk(mesh, q, base, 10)
    out["topk/exact/d"], out["topk/exact/i"] = pk.arr(d), pk.arr(i)
    rng = np.random.default_rng(1)
    base = rng.standard_normal((2048, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    mask = rng.random(2048) < 0.3
    d, i = pk.sharded_topk(mesh, q, base, 5, valid_mask=mask)
    out["topk/mask/d"], out["topk/mask/i"] = pk.arr(d), pk.arr(i)
    rng = np.random.default_rng(5)
    base = rng.standard_normal((203, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    d, i = pk.sharded_topk(mesh, q, base, 10)
    out["topk/nondiv/d"], out["topk/nondiv/i"] = pk.arr(d), pk.arr(i)
    mask = np.zeros(203, dtype=bool)
    mask[[3, 77, 202]] = True
    d, i = pk.sharded_topk(mesh, q, base, 10, valid_mask=mask)
    out["topk/sentinel/d"], out["topk/sentinel/i"] = pk.arr(d), pk.arr(i)


def case_plan(pk, quantize, out, dense=False):
    """``sharded_plan_topk`` on an attributed index: frozen, mid-delta
    (inserts and a delete past the watermark) cold and warm, compacted;
    answers, launches, ``sq8_stats`` and counters.  ``dense`` adds the
    mid-delta wave through the dense-mask oracle under ``dense_*`` (the
    reference compiles one sweep per entry there, which takes minutes on
    the CPU, so only the port runs it)."""
    mesh = pk.mesh(8)
    rng = np.random.default_rng(7)
    n, dim = 311, 16
    vecs, seqs, attrs = _records(rng, n, dim)
    vm = pk.VectorMaton(vecs, seqs, pk.Config(
        T=10 ** 9, auto_compact=False, quantize=quantize, schema=SCHEMA),
        attributes=attrs)
    vm.delete(5)             # before the residency: built into its mask
    vm.snapshot().to_device_sharded(mesh, n=n)
    queries = rng.standard_normal((len(PREDS), dim)).astype(np.float32)

    def phase(name, base, prefix="plan"):
        rt = vm.snapshot()
        plan = vm.plan(PREDS, rt)
        pk.ops.reset_launch_stats()
        res = pk.sharded_plan_topk(mesh, base, rt, queries, plan, 5)
        tag = f"{prefix}_{quantize}/{name}"
        _put_results(out, tag, res)
        st = pk.ops.launch_stats()
        for kind in ("sharded_sweep", "sq8_sharded_sweep"):
            out[f"{tag}/launch/{kind}"] = np.asarray(st.get(kind, 0))
        for key, v in rt.sq8_stats.items():
            out[f"{tag}/sq8/{key}"] = np.asarray(v)
        for key in COUNTERS:
            out[f"{tag}/traffic/{key}"] = np.asarray(rt.traffic[key])

    phase("frozen", n)
    for j in range(9):        # churn past the shard watermark
        vm.insert(rng.standard_normal(dim).astype(np.float32),
                  "".join(rng.choice(list("abcd"), size=8)),
                  attributes={"genre": GENRES[j % 3], "price": float(j)})
    vm.delete(n + 2)          # a delta tombstone, past the watermark
    phase("delta_cold", n)
    phase("delta_warm", n)
    if dense:
        vm.snapshot().shard_descriptors = False
        phase("delta_warm", n, prefix="dense")
        vm.snapshot().shard_descriptors = True
    vm.compact()
    phase("compacted", None)


def case_engine(pk, out):
    """``RetrievalEngine(mesh=...)`` beside the one-device engine."""
    mesh = pk.mesh(8)
    rng = np.random.default_rng(21)
    n, dim = 150, 16
    vecs, seqs, _ = _records(rng, n, dim, attributes=False)
    sharded = pk.Engine(vecs, seqs, pk.Config(T=10 ** 9), mesh=mesh)
    plain = pk.Engine(vecs, seqs, pk.Config(T=10 ** 9))
    preds = ["a", "ab", "ab OR cd", "NOT ab", "ab", "a"]
    reqs = [pk.Request(vector=rng.standard_normal(dim).astype(np.float32),
                       pattern=p, k=5) for p in preds]
    for tag, eng in (("engine/sharded", sharded), ("engine/plain", plain)):
        _put_results(out, tag, [(r.distances, r.ids)
                                for r in eng.serve_batch(reqs)])
    one = sharded.serve(reqs[0])
    _put_results(out, "engine/single", [(one.distances, one.ids)])


def case_restore(pk, tmp, out):
    """An index checkpointed under 8 shards, restored onto the 4-shard
    mesh ``ElasticPlan.remesh`` picks over 5 devices."""
    rng = np.random.default_rng(5)
    n, dim = 257, 16
    vecs, seqs, attrs = _records(rng, n, dim)
    cfg = pk.Config(T=10 ** 9, auto_compact=False, schema=SCHEMA)
    mesh8 = pk.mesh(8)
    eng = pk.Engine(vecs, seqs, cfg, mesh=mesh8, attributes=attrs)
    for j in range(7):
        eng.insert(rng.standard_normal(dim).astype(np.float32),
                   "".join(rng.choice(list("abcd"), size=8)),
                   attributes={"genre": GENRES[j % 3], "price": float(j)})
    eng.delete(3)
    path = os.path.join(tmp, f"{pk.name}_ckpt")
    eng.checkpoint(path, extra_meta={"lsn": 8})
    mesh4 = pk.ElasticPlan(tp_degree=1, old_data=8).remesh(
        pk.devices(mesh8, 5))
    out["restore/mesh_shape"] = np.asarray(mesh4.devices.shape)
    eng2 = pk.restore(path, mesh4)
    preds = PREDS[7:]
    queries = rng.standard_normal((len(preds), dim)).astype(np.float32)
    _put_results(out, "restore/answers",
                 eng2.query_batch(queries, preds, 5))
    eng2.insert(rng.standard_normal(dim).astype(np.float32), "abab",
                attributes={"genre": "rock", "price": 1.0})
    _put_results(out, "restore/after_insert",
                 eng2.query_batch(queries[:1], preds[:1], 5))


def reference_results(path: str) -> None:
    """Run every case through the reference (in a process with eight XLA
    host devices) and save the arrays to ``path``."""
    pk = ref_ns()
    out = {}
    case_topk(pk, out)
    for quantize in ("sq8", "none"):
        case_plan(pk, quantize, out)
    case_engine(pk, out)
    case_restore(pk, os.path.dirname(path), out)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ref")
    path = str(tmp / "ref.npz")
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")
        import jax
        assert len(jax.devices()) == 8
        sys.path.insert(0, {TESTS!r})
        import test_torch_sharded
        test_torch_sharded.reference_results({path!r})
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=420)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _port(case, *args):
    out = {}
    case(port_ns(), *args, out)
    return out


def _match(ref_out, port_out, prefix):
    keys = sorted(k for k in ref_out if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port_out
                                   if k.startswith(prefix))
    for key in keys:
        a, b = ref_out[key], port_out[key]
        if key.endswith("/d"):
            assert a.shape == b.shape, key
            fin = np.isfinite(a)
            assert np.array_equal(fin, np.isfinite(b)), key
            assert np.all(np.isposinf(b[~fin])), key
            if fin.any():
                tol = 1e-5 * max(float(np.abs(a[fin]).max()), 1.0)
                np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=tol,
                                           err_msg=key)
        else:
            assert np.array_equal(a, b), (key, a, b)


# --------------------------------------------------------------------- #
# held to the reference
# --------------------------------------------------------------------- #

def test_sharded_topk_matches_reference(reference):
    out = _port(case_topk)
    _match(reference, out, "topk/")
    i = out["topk/sentinel/i"]
    assert (i[:, 3:] == -1).all() and np.isinf(out["topk/sentinel/d"][:, 3:]
                                               ).all()
    assert set(i[:, :3].ravel().tolist()) <= {3, 77, 202}


@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_sharded_plan_matches_reference(reference, quantize):
    out = {}
    case_plan(port_ns(), quantize, out, dense=True)
    _match(reference, out, f"plan_{quantize}/")
    # the warm mid-delta wave reuploads no tail and ships no mask, and
    # every descriptor wave runs one sweep; the dense-mask oracle ships
    # masks and gives the same answers
    pre = f"plan_{quantize}/"
    assert (out[pre + "delta_warm/traffic/shard_tail_bytes"]
            == out[pre + "delta_cold/traffic/shard_tail_bytes"])
    assert out[pre + "delta_warm/traffic/shard_mask_bytes"] == 0
    assert out[f"dense_{quantize}/delta_warm/traffic/shard_mask_bytes"] > 0
    for phase in ("frozen", "delta_cold", "delta_warm", "compacted"):
        assert (out[pre + f"{phase}/launch/sharded_sweep"]
                + out[pre + f"{phase}/launch/sq8_sharded_sweep"]) == 1
    for r in range(len(PREDS)):
        a = out[pre + f"delta_warm/{r}/i"]
        assert np.array_equal(a, out[f"dense_{quantize}/delta_warm/{r}/i"])


def test_sharded_engine_matches_reference(reference):
    out = _port(case_engine)
    _match(reference, out, "engine/")
    for r in range(6):
        assert np.array_equal(out[f"engine/sharded/{r}/i"],
                              out[f"engine/plain/{r}/i"])


def test_sharded_restore_onto_smaller_mesh_matches_reference(reference,
                                                             tmp_path):
    out = _port(case_restore, str(tmp_path))
    _match(reference, out, "restore/")
    assert out["restore/mesh_shape"].tolist() == [4, 1]


# --------------------------------------------------------------------- #
# held to brute force, where the reference fails
# --------------------------------------------------------------------- #

def _brute(vm, ptext, q, k):
    pred = parse_predicate(ptext)
    attrs = vm.attributes
    ids = np.asarray([j for j, s in enumerate(vm.sequences)
                      if j not in vm.deleted
                      and pred.matches(s, attrs[j] if attrs else None)],
                     dtype=np.int64)
    if not len(ids):
        return []
    dd = ((q[None, :] - vm.vectors[ids]) ** 2).sum(-1)
    return ids[np.argsort(dd, kind="stable")[:k]].tolist()


def _check_brute(vm, res, preds, queries, k, tag=""):
    for r, p in enumerate(preds):
        assert res[r][1].tolist() == _brute(vm, p, queries[r], k), (tag, p)


@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_sharded_plan_descriptor_churn_exact(quantize):
    """The churn scenario the reference fails (a resident delete after the
    residency was built): answers equal brute force mid-delta and after
    compaction, the warm wave runs one sweep and ships no mask, the
    dense-mask oracle agrees, a stale plan is refused."""
    mesh = make_host_mesh(data=8, device="cpu")
    rng = np.random.default_rng(13)
    n, dim = 203, 16
    vecs, seqs, _ = _records(rng, n, dim, attributes=False)
    vm = VectorMaton(vecs, seqs, VectorMatonConfig(
        T=10 ** 9, auto_compact=False, quantize=quantize, device="cpu"))
    vm.snapshot().to_device_sharded(mesh, n=n)
    for _ in range(9):
        vm.insert(rng.standard_normal(dim).astype(np.float32),
                  "".join(rng.choice(list("abcd"), size=8)))
    vm.delete(5)
    vm.delete(n + 2)            # one resident, one delta tombstone
    preds = ["a", "ab", "ab AND cd", "NOT ab", "LIKE '%a%b%'", "a OR cd"]
    queries = rng.standard_normal((len(preds), dim)).astype(np.float32)
    rt = vm.snapshot()
    plan = vm.plan(preds, rt)
    res = port_ss.sharded_plan_topk(mesh, n, rt, queries, plan, 5)
    _check_brute(vm, res, preds, queries, 5, "cold")
    assert bool(rt.to_device_sharded(mesh, n=n).deleted[0][5])
    assert rt.traffic["shard_mask_bytes"] == 0

    ops.reset_launch_stats()
    tails = rt.traffic["shard_tail_bytes"]
    res2 = port_ss.sharded_plan_topk(mesh, n, rt, queries, plan, 5)
    st = ops.launch_stats()
    assert (st.get("sharded_sweep", 0)
            + st.get("sq8_sharded_sweep", 0)) == 1, st
    assert rt.traffic["shard_tail_bytes"] == tails
    assert rt.traffic["shard_mask_bytes"] == 0

    rt.shard_descriptors = False
    res3 = port_ss.sharded_plan_topk(mesh, n, rt, queries, plan, 5)
    rt.shard_descriptors = True
    for (da, ia), (db, ib) in zip(res2, res3):
        assert np.array_equal(ia, ib)
        np.testing.assert_allclose(da, db, atol=1e-4)
    assert rt.traffic["shard_mask_bytes"] > 0

    vm.compact()
    rt2 = vm.snapshot()
    plan2 = vm.plan(preds, rt2)
    res4 = port_ss.sharded_plan_topk(mesh, None, rt2, queries, plan2, 5)
    _check_brute(vm, res4, preds, queries, 5, "compacted")
    with pytest.raises(ValueError, match="generation"):
        port_ss.sharded_plan_topk(mesh, None, rt2, queries, plan, 5)


def test_sharded_deletes_after_build_attributed_brute_force():
    """Resident deletes landing between warm waves on an attributed index
    (``sync_tombstones`` runs at the head of each batch) through the
    engine over a mesh: every wave equals brute force."""
    mesh = make_host_mesh(data=8, device="cpu")
    rng = np.random.default_rng(3)
    n, dim = 240, 16
    vecs, seqs, attrs = _records(rng, n, dim)
    eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(
        T=10 ** 9, auto_compact=False, schema=SCHEMA, device="cpu"),
        mesh=mesh, attributes=attrs)
    queries = rng.standard_normal((len(PREDS), 16)).astype(np.float32)
    for wave in range(4):
        res = eng.query_batch(queries, PREDS, 6)
        _check_brute(eng.index, res, PREDS, queries, 6, f"wave {wave}")
        for gid in rng.choice(n, 25, replace=False):
            eng.delete(int(gid))
        eng.insert(rng.standard_normal(dim).astype(np.float32), "abab",
                   attributes={"genre": "rock", "price": 4.0})


# --------------------------------------------------------------------- #
# held to the port's own paths
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("quantize", ["sq8", "none"])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_shard_counts_equal_single_device(shards, quantize):
    rng = np.random.default_rng(11)
    n, dim = 277, 16
    vecs, seqs, attrs = _records(rng, n, dim)
    cfg = dict(T=10 ** 9, auto_compact=False, schema=SCHEMA,
               quantize=quantize, device="cpu")
    plain = VectorMaton(vecs, seqs, VectorMatonConfig(**cfg),
                        attributes=attrs)
    eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(**cfg),
                          mesh=make_host_mesh(data=shards, device="cpu"),
                          attributes=attrs)
    queries = rng.standard_normal((len(PREDS), dim)).astype(np.float32)
    for _ in range(2):
        got = eng.query_batch(queries, PREDS, 7)
        want = plain.query_batch(queries, PREDS, 7)
        for (d, i), (dw, iw) in zip(got, want):
            assert i.tolist() == iw.tolist()
            np.testing.assert_allclose(d, dw, rtol=1e-5, atol=1e-5)
        v = rng.standard_normal(dim).astype(np.float32)
        for vm in (plain, eng.index):
            vm.insert(v, "abcab", attributes={"genre": "pop",
                                              "price": 3.5})
            vm.delete(17)


def test_sq8_escalation_and_streak_policy(monkeypatch):
    """A batch whose certificate fails escalates to the fp32 sweep; after
    ``SQ8_MAX_STREAK`` failures in a row the runtime sweeps fp32 outright
    (counted as fallbacks); the answers stay the fp32 sweep's."""
    real = port_ss._sweep_sq8

    def failing(*args):
        v, i, _ = real(*args)
        return v, i, torch.ones((), dtype=torch.int64)

    monkeypatch.setattr(port_ss, "_sweep_sq8", failing)
    rng = np.random.default_rng(8)
    vecs, seqs, _ = _records(rng, 160, 16, attributes=False)
    cfg = dict(T=10 ** 9, auto_compact=False, device="cpu")
    eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(**cfg),
                          mesh=make_host_mesh(data=3, device="cpu"))
    plain = VectorMaton(vecs, seqs, VectorMatonConfig(quantize="none",
                                                      **cfg))
    preds = ["a", "ab", "ab AND cd", "NOT ab"]
    ops.reset_launch_stats()
    for _ in range(5):
        q = rng.standard_normal((len(preds), 16)).astype(np.float32)
        got = eng.query_batch(q, preds, 5)
        for (d, i), (dw, iw) in zip(got, plain.query_batch(q, preds, 5)):
            assert i.tolist() == iw.tolist()
    assert eng.index.snapshot().sq8_stats == {
        "batches": 3, "certified": 0, "escalations": 3, "fallbacks": 2}
    st = ops.launch_stats()
    assert st["sq8_sharded_sweep"] == 3 and st["sharded_sweep"] == 5


def test_merge_topk_allgather_tie_rule_matches_lax_top_k():
    """Exact ties across and within shards: the lower pool position
    (lower shard, then lower local slot) wins, as ``lax.top_k`` orders
    the reference's all-gathered pool; sentinels come back (+inf, -1)."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    rng = np.random.default_rng(4)
    s, q, k = 4, 6, 5
    vals = rng.integers(0, 4, (s, q, k)).astype(np.float32)
    vals[1, 2, 3:] = np.inf
    vals[:, 5, :] = np.inf
    vals[:, 5, 0] = 2.0
    gids = rng.permutation(s * q * k).reshape(s, q, k).astype(np.int64)
    gids[1, 2, 3:] = -1
    gids[:, 5, 1:] = -1
    av = np.transpose(vals, (1, 0, 2)).reshape(q, -1)
    ai = np.transpose(gids, (1, 0, 2)).reshape(q, -1)
    neg, pos = jax.lax.top_k(-jnp.asarray(av), k)
    want_v = -np.asarray(neg)
    want_i = np.take_along_axis(ai, np.asarray(pos), 1)
    bad = ~np.isfinite(want_v) | (want_i < 0)
    want_v[bad], want_i[bad] = np.inf, -1
    got_v, got_i = ops.merge_topk_allgather(torch.from_numpy(vals),
                                            torch.from_numpy(gids), k)
    assert np.array_equal(got_i.numpy(), want_i)
    assert np.array_equal(got_v.numpy(), want_v)


def test_residency_codes_bit_equal_reference_quantization():
    """The shard tables hold the reference's SQ8 codes, scales and code
    L1 norms bit for bit (``sharded_search.py:169-180``), and pad rows
    quantize to zero codes."""
    rng = np.random.default_rng(9)
    n, dim = 101, 16
    vecs, seqs, _ = _records(rng, n, dim, attributes=False)
    vm = VectorMaton(vecs, seqs, VectorMatonConfig(
        T=10 ** 9, device="cpu"))
    sh = vm.snapshot().to_device_sharded(make_host_mesh(data=4,
                                                        device="cpu"))
    vec = np.zeros((sh.n_pad, dim), np.float32)
    vec[:n] = vecs
    scale = (np.abs(vec).max(axis=1, keepdims=True).astype(np.float32)
             / 127.0 + 1e-12)
    codes = np.clip(np.rint(vec / scale), -127, 127).astype(np.int8)
    l1 = np.abs(codes.astype(np.int32)).sum(axis=1, keepdims=True)
    sqn = (vec * vec).sum(axis=1, keepdims=True, dtype=np.float32)
    got = [torch.cat([t[j] for t in sh.quant]).numpy() for j in range(4)]
    assert np.array_equal(got[0], codes)
    assert np.array_equal(got[1], scale.astype(np.float32))
    np.testing.assert_allclose(got[2], sqn, rtol=1e-6)
    assert np.array_equal(got[3], l1.astype(np.float32))
    # shards on one device are slices of one table
    assert sh.vectors[1].data_ptr() == (sh.vectors[0].data_ptr()
                                        + sh.local_n * dim * 4)


def test_mesh_equality_and_remesh():
    m = make_host_mesh(data=4, device="cpu")
    assert m.shape == {"data": 4, "model": 1} and m.size == 4
    assert m == make_host_mesh(data=4, device="cpu")
    assert hash(m) == hash(make_host_mesh(data=4, device="cpu"))
    assert m != make_host_mesh(data=2, device="cpu")
    m2 = ElasticPlan(tp_degree=1, old_data=4).remesh(m.devices.flat[:3])
    assert isinstance(m2, Mesh) and m2.shape == {"data": 2, "model": 1}
    assert m2 == make_host_mesh(data=2, device="cpu")
    with pytest.raises(ValueError):
        Mesh(np.empty((0, 1), dtype=object), ("data", "model"))


def test_pipelined_batcher_over_mesh_equals_sync():
    """The pipelined batcher serves a mesh engine without staging, and
    its answers equal the synchronous loop's through writes."""
    rng = np.random.default_rng(2)
    vecs, seqs, _ = _records(rng, 180, 16, attributes=False)
    preds = ["a", "ab", "ab AND cd", "NOT ab", "LIKE '%a%b%'", "a OR cd"]
    reqs = [Request(vector=rng.standard_normal(16).astype(np.float32),
                    pattern=preds[j % len(preds)], k=4) for j in range(24)]
    ins = rng.standard_normal((3, 16)).astype(np.float32)
    got = {}
    for pipeline in (False, True):
        eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(
            T=10 ** 9, auto_compact=False, device="cpu"),
            mesh=make_host_mesh(data=4, device="cpu"))
        b = ContinuousBatcher(eng, budget=10 ** 9, max_wave=8,
                              pipeline=pipeline)
        try:
            tickets = [b.submit(r) for r in reqs[:12]]
            for v in ins:
                b.submit_insert(v, "abcd")
            b.submit_delete(3)
            tickets += [b.submit(r) for r in reqs[12:]]
            res = b.drain(deadline_s=120)
            if pipeline:
                assert b._pipe._ring is None
        finally:
            b.close()
        got[pipeline] = [res[t].ids.tolist() for t in tickets]
        _check_brute(eng.index, [(res[t].distances, res[t].ids)
                                 for t in tickets[12:]],
                     [r.pattern for r in reqs[12:]],
                     np.stack([r.vector for r in reqs[12:]]), 4)
    assert got[False] == got[True]


def test_replica_reshards_on_rejoin(tmp_path):
    """A replica that left with 4 devices and rejoins with 3 is restored
    onto the 2-shard mesh ``ElasticPlan.remesh`` picks, and after the log
    replay answers as the leader does."""
    rng = np.random.default_rng(6)
    vecs, seqs, _ = _records(rng, 90, 16, attributes=False)
    cfg = VectorMatonConfig(T=10 ** 9, auto_compact=False, device="cpu")
    mesh4 = make_host_mesh(data=4, device="cpu")
    rs = port_repl.ReplicaSet(
        vecs, seqs, cfg, n_replicas=2, ckpt_dir=str(tmp_path / "ckpt"),
        engine_factory=lambda: RetrievalEngine(vecs, seqs, cfg,
                                               mesh=mesh4))
    rs.replicas["r1"].devices = list(mesh4.devices.flat)
    rs.checkpoint()
    rs.replicas["r1"].kill()
    for _ in range(3):
        rs.apply_write("insert", vector=rng.standard_normal(16).astype(
            np.float32), sequence="abab")
    rs.apply_write("delete", vector_id=7)
    r1 = rs.restore_replica("r1", devices=list(mesh4.devices.flat[:3]))
    assert r1.engine.mesh.shape == {"data": 2, "model": 1}
    assert rs.ship(r1) == rs.log.tail
    q = rng.standard_normal((2, 16)).astype(np.float32)
    want = rs.leader.engine.query_batch(q, ["ab", "a"], 4)
    got = r1.engine.query_batch(q, ["ab", "a"], 4)
    for (dw, iw), (d, i) in zip(want, got):
        assert i.tolist() == iw.tolist()
        np.testing.assert_allclose(d, dw, atol=1e-5)


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", ["sq8", "none"])
def test_gpu_sharded_equals_single_device_and_launches_kernels(cuda,
                                                               quantize):
    """On the card, 1 and 4 shards equal the one-device path through
    churn, each shard's sweep launches kernel A or kernel B once a wave,
    and ``sharded_topk`` equals the CPU's plain versions."""
    rng = np.random.default_rng(12)
    n, dim = 4000, 32
    vecs, seqs, attrs = _records(rng, n, dim)
    cfg = dict(T=10 ** 9, auto_compact=False, schema=SCHEMA,
               quantize=quantize, device="cuda")
    queries = rng.standard_normal((len(PREDS), dim)).astype(np.float32)
    for shards in (1, 4):
        plain = VectorMaton(vecs, seqs, VectorMatonConfig(**cfg),
                            attributes=attrs)
        eng = RetrievalEngine(vecs, seqs, VectorMatonConfig(**cfg),
                              mesh=make_host_mesh(data=shards),
                              attributes=attrs)
        for wave in range(3):
            before = (distance_topk.topk_seg_f32.launches,
                      quant.qtopk_seg_sq8.launches)
            got = eng.query_batch(queries, PREDS, 8)
            a = distance_topk.topk_seg_f32.launches - before[0]
            b = quant.qtopk_seg_sq8.launches - before[1]
            assert a + b in (shards, 2 * shards), (a, b)
            want = plain.query_batch(queries, PREDS, 8)
            for (d, i), (dw, iw) in zip(got, want):
                assert i.tolist() == iw.tolist()
                np.testing.assert_allclose(d, dw, rtol=1e-4, atol=1e-4)
            v = rng.standard_normal(dim).astype(np.float32)
            for vm in (plain, eng.index):
                vm.insert(v, "abab", attributes={"genre": "rock",
                                                 "price": 2.0})
                vm.delete(40 + wave)
    base = rng.standard_normal((3001, dim)).astype(np.float32)
    mask = rng.random(3001) < 0.4
    q = rng.standard_normal((9, dim)).astype(np.float32)
    d, i = port_ss.sharded_topk(make_host_mesh(data=4, device="cuda:0"),
                                q, torch.from_numpy(base).cuda(), 10,
                                valid_mask=mask)
    assert make_host_mesh(data=4) == make_host_mesh(data=4,
                                                    device="cuda:0")
    dc, ic = port_ss.sharded_topk(make_host_mesh(data=4, device="cpu"), q,
                                  base, 10, valid_mask=mask)
    assert torch.equal(i.cpu(), ic)
    np.testing.assert_allclose(d.cpu().numpy(), dc.numpy(), rtol=1e-4,
                               atol=1e-4)

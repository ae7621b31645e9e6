"""Replica groups, the router and failure detection of the port against
the reference.

Every test of ``tests/test_replication.py`` and
``tests/test_fault_tolerance.py`` has a counterpart here.  Each runs the
same seeded scenario through ``repro_torch`` (``device="cpu"``) and
through ``repro``: the write ids, watermarks, router counters and fault
events must be equal, answers equal in ids and within atol 2e-4 / rtol
1e-4 in distance.  The reference runs its host executor here, as its own
tests do: ``repro``'s ``RetrievalEngine.restore`` loads a replica on the
default backend whatever the set ran on, so a JAX replica set would mix
executors after a rejoin.  The indexes are raw-only (every answer is an
exact scan), so the two executors must agree.  Where the reference holds the
replicated path against a single-replica oracle, the port's path is held
against the port's own oracle, bit for bit.  The pure-Python monitors
must give the reference's verdicts.  ``ElasticPlan.remesh`` builds a
mesh of the same shape in both packages.

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import types

import numpy as np
import pytest

from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
from repro_torch.distributed import elastic as port_elastic
from repro_torch.distributed import replication as port_repl
from repro_torch.serve import router as port_router
from repro_torch.serve.engine import RetrievalEngine

DIM = 8
ALPHA = "abcd"

PORT = types.SimpleNamespace(
    name="port", VectorMaton=VectorMaton, Engine=RetrievalEngine,
    repl=port_repl, Router=port_router.ReplicatedRouter,
    elastic=port_elastic,
    config=lambda **kw: VectorMatonConfig(device="cpu", **kw))


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    vm = imp("repro.core.vectormaton")
    return types.SimpleNamespace(
        name="ref", VectorMaton=vm.VectorMaton,
        Engine=imp("repro.serve.engine").RetrievalEngine,
        repl=imp("repro.distributed.replication"),
        Router=imp("repro.serve.router").ReplicatedRouter,
        elastic=imp("repro.distributed.elastic"),
        config=lambda **kw: vm.VectorMatonConfig(backend="numpy", **kw))


class FakeClock:
    """Injectable time source: ``clock()`` for liveness decisions,
    ``sleep`` records the backoff sequence and advances time."""

    def __init__(self, t: float = 0.0):
        self.t = t
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s

    def advance(self, s):
        self.t += s


def _corpus(rng, n, dim=DIM):
    seqs = ["".join(rng.choice(list(ALPHA), size=rng.integers(5, 12)))
            for _ in range(n)]
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return vecs, seqs


def _cfg(pk, **kw):
    # raw-only (T = inf): every strategy exact
    kw.setdefault("T", 10 ** 9)
    kw.setdefault("auto_compact", False)
    kw.setdefault("M", 8)
    kw.setdefault("seed", 7)
    return pk.config(**kw)


def _mk_set(pk, tmp_path, n=40, n_replicas=2, rng=None, **cfg_kw):
    rng = rng or np.random.default_rng(0)
    vecs, seqs = _corpus(rng, n)
    rs = pk.repl.ReplicaSet(vecs, seqs, _cfg(pk, **cfg_kw),
                            n_replicas=n_replicas,
                            ckpt_dir=str(tmp_path / pk.name / "ckpt"))
    return rs, rng


def _oracle(pk, seed=0, n=40):
    return pk.VectorMaton(*_corpus(np.random.default_rng(seed), n),
                          _cfg(pk))


def _both(ref, fn):
    return {pk.name: fn(pk) for pk in (ref, PORT)}


def _agree(res_ref, res_port):
    """Two [(dists, ids)] lists (or lists of them) give the same
    answers."""
    assert len(res_ref) == len(res_port)
    for a, b in zip(res_ref, res_port):
        if isinstance(a, list):
            _agree(a, b)
            continue
        (dr, ir), (dp, ip) = a, b
        assert ir.tolist() == ip.tolist()
        np.testing.assert_allclose(dp, dr, atol=2e-4, rtol=1e-4)


# --------------------------------------------------------------------- #
# DeltaLog
# --------------------------------------------------------------------- #

def test_delta_log_ordering_batch_truncation(ref):
    def run(pk):
        log = pk.repl.DeltaLog()
        for i in range(1, 6):
            log.append(pk.repl.DeltaRecord(lsn=i, op="delete", vector_id=i))
        assert log.tail == 5 and len(log) == 5
        with pytest.raises(ValueError):
            log.append(pk.repl.DeltaRecord(lsn=9, op="delete", vector_id=9))
        seen = [[r.lsn for r in log.batch(2)],
                [r.lsn for r in log.batch(0, upto=2)]]
        assert seen == [[3, 4, 5], [1, 2]]
        assert log.truncate(3) == 3
        assert log.floor == 3 and log.tail == 5 and len(log) == 2
        seen.append([r.lsn for r in log.batch(3)])
        with pytest.raises(pk.repl.ReplicationGap):
            log.batch(1)
        assert log.truncate(2) == 0
        return seen, log.floor, log.tail

    out = _both(ref, run)
    assert out["ref"] == out["port"]


# --------------------------------------------------------------------- #
# follower apply: idempotency, gaps, divergence
# --------------------------------------------------------------------- #

def _insert3(pk, rs, rng):
    for _ in range(3):
        rs.apply_write("insert",
                       vector=rng.standard_normal(DIM).astype(np.float32),
                       sequence="abab")


def test_apply_duplicate_batch_is_idempotent(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path)
        r1 = rs.replicas["r1"]
        _insert3(pk, rs, rng)
        batch = rs.log.batch(0)
        assert r1.apply(batch) == 3
        before = r1.engine.maintenance_stats()["delta_version"]
        assert r1.apply(batch) == 3
        assert r1.engine.maintenance_stats()["delta_version"] == before
        return before, [r.vector_id for r in batch]

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_apply_gap_raises(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path)
        r1 = rs.replicas["r1"]
        _insert3(pk, rs, rng)
        with pytest.raises(pk.repl.ReplicationGap):
            r1.apply(rs.log.batch(1))
        assert r1.applied == 0
        return r1.applied

    assert _both(ref, run) == {"ref": 0, "port": 0}


def test_apply_divergent_insert_id_raises(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path)
        rec, vid = rs.apply_write(
            "insert", vector=rng.standard_normal(DIM).astype(np.float32),
            sequence="abab")
        bad = pk.repl.DeltaRecord(lsn=1, op="insert", vector=rec.vector,
                                  sequence=rec.sequence, vector_id=vid + 17)
        with pytest.raises(pk.repl.ReplicaDiverged):
            rs.replicas["r1"].apply([bad])
        return vid, rec.generation, rec.delta_version

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_dead_replica_rejects_traffic(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path)
        r1 = rs.replicas["r1"]
        r1.kill()
        with pytest.raises(pk.repl.ReplicaDead):
            r1.serve_wave(rng.standard_normal((1, DIM)).astype(np.float32),
                          ["ab"], 3)
        rs.apply_write("delete", vector_id=0)
        with pytest.raises(pk.repl.ReplicaDead):
            rs.ship(r1)
        return rs.log.tail, r1.applied

    out = _both(ref, run)
    assert out["ref"] == out["port"]


# --------------------------------------------------------------------- #
# write funnel + leader failover
# --------------------------------------------------------------------- #

def test_replicated_writes_reach_followers_exactly(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=3)
        clk = FakeClock()
        router = pk.Router(rs, max_lag=4, clock=clk, sleep=clk.sleep)
        oracle = _oracle(pk)
        for _ in range(6):
            v = rng.standard_normal(DIM).astype(np.float32)
            s = "".join(rng.choice(list(ALPHA), size=8))
            assert router.submit_insert(v, s) == oracle.insert(v, s)
        router.submit_delete(2)
        oracle.delete(2)
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        pats = ["ab", "a AND NOT cd"]
        want = oracle.query_batch(q, pats, 5)
        got_all = []
        for _ in range(3):
            got = router.serve_wave(q, pats, 5)
            for (gd, gi), (wd, wi) in zip(got, want):
                assert gi.tolist() == wi.tolist()
                assert np.array_equal(gd, wd)
            got_all.append(got)
        router.assert_no_loss()
        assert all(r.applied == rs.log.tail for r in rs.replicas.values())
        return got_all

    out = _both(ref, run)
    _agree(out["ref"], out["port"])


def test_leader_failover_promotes_highest_watermark(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=3)
        clk = FakeClock()
        router = pk.Router(rs, clock=clk, sleep=clk.sleep)
        v = rng.standard_normal(DIM).astype(np.float32)
        router.submit_insert(v, "abab")
        rs.ship(rs.replicas["r2"])
        rs.replicas["r0"].kill()
        vid = router.submit_insert(v, "baba")
        assert rs.leader_name == "r2"
        assert router.stats["leader_promotions"] == 1
        assert vid == 41
        assert rs.leader.applied == rs.log.tail
        return rs.leader_name, vid, dict(router.stats)

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_promoted_leader_replays_before_writing(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=2)
        for _ in range(4):
            rs.apply_write(
                "insert", vector=rng.standard_normal(DIM).astype(np.float32),
                sequence="abab")
        assert rs.replicas["r1"].applied == 0
        rs.replicas["r0"].kill()
        rs.promote("r1")
        _, vid = rs.apply_write(
            "insert", vector=rng.standard_normal(DIM).astype(np.float32),
            sequence="abab")
        assert vid == 44
        return vid, rs.leader.applied

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_no_healthy_replica(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=2)
        clk = FakeClock()
        router = pk.Router(rs, clock=clk, sleep=clk.sleep)
        for r in rs.replicas.values():
            r.kill()
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        with pytest.raises(pk.repl.NoHealthyReplica):
            router.serve_wave(q, ["ab"], 3)
        with pytest.raises(pk.repl.NoHealthyReplica):
            router.submit_insert(q[0], "abab")
        return dict(router.stats)

    out = _both(ref, run)
    assert out["ref"] == out["port"]


# --------------------------------------------------------------------- #
# routing policy: staleness bound, backoff, reships
# --------------------------------------------------------------------- #

def test_stalled_replica_excluded_once_lag_exceeds_bound(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=2)
        clk = FakeClock()
        inj = pk.repl.FaultInjector()
        inj.stall("r1", from_wave=1, until_wave=100)
        router = pk.Router(rs, max_lag=2, heartbeat_timeout_s=1e9,
                           clock=clk, sleep=clk.sleep, injector=inj)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        answers = []
        for _ in range(6):
            router.submit_insert(
                rng.standard_normal(DIM).astype(np.float32), "abab")
            answers.append(router.serve_wave(q, ["ab"], 3))
        assert rs.replicas["r1"].applied == 0
        assert rs.lag(rs.replicas["r1"]) == 6
        assert rs.replicas["r0"].waves_served >= 4
        router.assert_no_loss()
        return answers, rs.replicas["r0"].waves_served, dict(router.stats)

    out = _both(ref, run)
    _agree(out["ref"][0], out["port"][0])
    assert out["ref"][1:] == out["port"][1:]


def test_retry_backoff_sequence_capped(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=4)
        clk = FakeClock()
        router = pk.Router(rs, clock=clk, sleep=clk.sleep,
                           backoff_base_s=0.05, backoff_cap_s=0.08)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        router.serve_wave(q, ["ab"], 3)
        for name in ("r1", "r2", "r3"):
            rs.replicas[name].kill()
        router.serve_wave(q, ["ab"], 3)
        assert clk.sleeps == [0.05, 0.08, 0.08]
        assert router.stats["retries"] == 3
        assert router.stats["ejected"] == 3
        router.assert_no_loss()
        return clk.sleeps, dict(router.stats)

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_dropped_batch_reships_and_stays_exact(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=2)
        clk = FakeClock()
        inj = pk.repl.FaultInjector()
        inj.drop_batch(1)
        inj.duplicate_batch(3)
        router = pk.Router(rs, clock=clk, sleep=clk.sleep, injector=inj)
        oracle = _oracle(pk)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        answers = []
        for _ in range(4):
            v = rng.standard_normal(DIM).astype(np.float32)
            router.submit_insert(v, "abab")
            oracle.insert(v, "abab")
            got = router.serve_wave(q, ["ab"], 4)
            want = oracle.query_batch(q, ["ab"], 4)
            assert got[0][1].tolist() == want[0][1].tolist()
            answers.append(got)
        assert router.stats["reships"] >= 1
        assert ("drop_batch", 1) in inj.events
        assert ("duplicate_batch", 3) in inj.events
        assert all(r.applied == rs.log.tail for r in rs.replicas.values())
        return answers, inj.events, dict(router.stats)

    out = _both(ref, run)
    _agree(out["ref"][0], out["port"][0])
    assert out["ref"][1:] == out["port"][1:]


# --------------------------------------------------------------------- #
# rejoin + checkpoint/truncation interplay
# --------------------------------------------------------------------- #

def test_rejoin_restores_checkpoint_and_replays(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=2)
        clk = FakeClock()
        router = pk.Router(rs, max_lag=2, heartbeat_timeout_s=5.0,
                           clock=clk, sleep=clk.sleep, checkpoint_every=2)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        rs.replicas["r1"].kill()
        for _ in range(6):
            router.submit_insert(
                rng.standard_normal(DIM).astype(np.float32), "abab")
            router.serve_wave(q, ["ab"], 3)
            clk.advance(3.0)
        assert not rs.replicas["r1"].serving
        assert router.stats["checkpoints"] >= 1
        r1 = router.rejoin("r1")
        assert r1.serving and r1.alive
        assert rs.lag(r1) == 0
        assert r1.restores == 1
        want = rs.leader.engine.query_batch(q, ["ab"], 3)
        got = r1.engine.query_batch(q, ["ab"], 3)
        assert got[0][1].tolist() == want[0][1].tolist()
        assert np.array_equal(got[0][0], want[0][0])
        return got, dict(router.stats)

    out = _both(ref, run)
    _agree(out["ref"][0], out["port"][0])
    assert out["ref"][1] == out["port"][1]
    # the port's rejoiner kept the port's configuration and device
    rs, _ = _mk_set(PORT, tmp_path / "again", n_replicas=2)
    rs.replicas["r1"].kill()
    r1 = rs.restore_replica("r1")
    assert r1.engine.index.config.device == "cpu"
    assert r1.engine.index.config.backend == "torch"


def test_log_truncation_bounded_by_checkpoint_and_acks(ref, tmp_path):
    def run(pk):
        rs, rng = _mk_set(pk, tmp_path, n_replicas=2)
        for _ in range(5):
            rs.apply_write(
                "insert", vector=rng.standard_normal(DIM).astype(np.float32),
                sequence="abab")
        assert rs.truncate_log() == 0
        rs.ship(rs.replicas["r1"])
        rs.checkpoint()
        assert rs.truncate_log() == 5
        assert rs.log.floor == 5 and rs.log.tail == 5
        return rs.stats()

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_from_engine_seeds_log_from_live_delta(ref, tmp_path):
    """Attaching replication to an already-churned engine: the unfolded
    delta (insert order preserved) and tombstones seed the log, and a
    bootstrapped follower answers identically."""
    def run(pk):
        rng = np.random.default_rng(3)
        vecs, seqs = _corpus(rng, 40)
        eng = pk.Engine(vecs, seqs, _cfg(pk))
        for _ in range(4):
            eng.insert(rng.standard_normal(DIM).astype(np.float32), "abab")
        eng.delete(1)
        rs = pk.repl.ReplicaSet.from_engine(
            eng, n_replicas=2, ckpt_dir=str(tmp_path / pk.name / "ckpt"))
        assert rs.log.tail == 5
        assert all(r.applied == 5 for r in rs.replicas.values())
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        want = eng.query_batch(q, ["ab"], 5)
        got = rs.replicas["r1"].engine.query_batch(q, ["ab"], 5)
        assert got[0][1].tolist() == want[0][1].tolist()
        rs.apply_write(
            "insert", vector=rng.standard_normal(DIM).astype(np.float32),
            sequence="baba")
        rs.ship(rs.replicas["r1"])
        assert rs.replicas["r1"].applied == 6
        return got, [(r.op, r.vector_id) for r in rs.log.batch(0)]

    out = _both(ref, run)
    _agree(out["ref"][0], out["port"][0])
    assert out["ref"][1] == out["port"][1]


# --------------------------------------------------------------------- #
# tests/test_fault_tolerance.py: monitors and the elastic plan
# --------------------------------------------------------------------- #

def test_heartbeat_lifecycle(ref):
    def run(pk):
        hb = pk.elastic.HeartbeatMonitor(["h0", "h1"], timeout_s=10.0)
        t0 = 1000.0
        hb.beat("h0", now=t0)
        hb.beat("h1", now=t0)
        seen = [hb.check(now=t0 + 5)]
        assert seen[0] == {"h0": "ok", "h1": "ok"}
        hb.beat("h0", now=t0 + 12)
        seen.append(hb.check(now=t0 + 15))
        assert seen[-1]["h1"] == "suspect"
        seen.append(hb.check(now=t0 + 30))
        assert seen[-1]["h1"] == "dead"
        assert hb.dead_hosts() == ["h1"]
        hb.beat("h1", now=t0 + 31)
        seen.append(hb.check(now=t0 + 32))
        assert seen[-1]["h1"] == "ok"
        return seen

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_straggler_detection(ref):
    def run(pk):
        sm = pk.elastic.StragglerMonitor(threshold=3.0)
        rng = np.random.default_rng(0)
        for _ in range(16):
            for h in range(8):
                t = 1.0 + rng.normal(0, 0.01)
                if h == 7:
                    t *= 1.8
                sm.record(f"h{h}", t)
        assert sm.stragglers() == ["h7"]
        assert sm.should_checkpoint_and_rebalance()
        return sm.stragglers()

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_no_false_positives_on_uniform_times(ref):
    def run(pk):
        sm = pk.elastic.StragglerMonitor()
        for _ in range(16):
            for h in range(8):
                sm.record(f"h{h}", 1.0 + 0.001 * h)
        assert sm.stragglers() == []
        return sm.stragglers()

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_elastic_plan_keeps_tp(ref):
    def run(pk):
        plan = pk.elastic.ElasticPlan(tp_degree=16, old_data=16)
        got = [plan.plan(256), plan.plan(240), plan.plan(17)]
        assert got == [(16, 16), (8, 16), (1, 16)]
        with pytest.raises(RuntimeError):
            plan.plan(8)
        return got

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_elastic_remesh_devices(ref):
    """Both packages build a (data, model) mesh of the planned shape over
    the first devices given."""
    jax = importlib.import_module("jax")
    mesh = ref.elastic.ElasticPlan(tp_degree=1, old_data=1).remesh(
        jax.devices())
    assert mesh.axis_names == ("data", "model")
    plan = port_elastic.ElasticPlan(tp_degree=1, old_data=1)
    got = plan.remesh(["cpu"] * len(jax.devices()))
    assert got.axis_names == mesh.axis_names
    assert got.devices.shape == mesh.devices.shape
    assert plan.plan(len(jax.devices())) == (len(mesh.devices), 1)
    assert port_elastic.ElasticPlan(tp_degree=1, old_data=8).remesh(
        ["cpu"] * 5).devices.shape == (4, 1)


def test_heartbeat_fully_injectable_clock(ref):
    def run(pk):
        clk = FakeClock(t=500.0)
        hb = pk.elastic.HeartbeatMonitor(["h0", "h1"], timeout_s=10.0,
                                         clock=clk)
        seen = [hb.check()]
        assert seen[0] == {"h0": "ok", "h1": "ok"}
        clk.advance(12.0)
        hb.beat("h0")
        seen.append(hb.check())
        assert seen[-1] == {"h0": "ok", "h1": "suspect"}
        clk.advance(12.0)
        seen.append(hb.check())
        assert seen[-1]["h1"] == "dead"
        assert hb.dead_hosts() == ["h1"]
        return seen

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_heartbeat_dead_at_first_check_after_two_windows(ref):
    def run(pk):
        hb = pk.elastic.HeartbeatMonitor(["h0"], timeout_s=10.0)
        hb.beat("h0", now=100.0)
        assert hb.check(now=135.0)["h0"] == "dead"
        hb2 = pk.elastic.HeartbeatMonitor(["h0"], timeout_s=10.0)
        hb2.beat("h0", now=100.0)
        verdicts = [hb2.check(now=100.0 + 0.1 * i)["h0"]
                    for i in range(260)]
        assert verdicts[99] == "ok"
        assert verdicts[101] == "suspect"
        assert verdicts[201] == "dead"
        assert hb2.dead_hosts() == ["h0"]
        return verdicts

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_heartbeat_add_remove_host(ref):
    def run(pk):
        hb = pk.elastic.HeartbeatMonitor(["h0"], timeout_s=10.0)
        hb.beat("h0", now=0.0)
        hb.add_host("h1", now=25.0)
        v = hb.check(now=29.0)
        assert v == {"h0": "dead", "h1": "ok"}
        hb.remove_host("h0")
        assert hb.check(now=29.0) == {"h1": "ok"}
        assert hb.dead_hosts() == []
        return v

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_straggler_samples_age_out(ref):
    def run(pk):
        clk = FakeClock()
        sm = pk.elastic.StragglerMonitor(threshold=3.0, max_age_s=60.0,
                                         clock=clk)
        for _ in range(8):
            for h in range(8):
                sm.record(f"h{h}", 5.0 if h == 7 else 1.0)
        before = sm.stragglers()
        assert before == ["h7"]
        clk.advance(120.0)
        for _ in range(4):
            for h in range(8):
                sm.record(f"h{h}", 1.0)
        assert sm.stragglers() == []
        assert not sm.should_checkpoint_and_rebalance()
        return before

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_straggler_min_abs_slack_ignores_micro_noise(ref):
    def run(pk):
        sm = pk.elastic.StragglerMonitor(threshold=3.0, min_abs_s=0.1)
        for _ in range(8):
            for h in range(8):
                sm.record(f"h{h}", 0.0010 + (0.0008 if h == 7 else 0.0))
        assert sm.stragglers() == []
        sm2 = pk.elastic.StragglerMonitor(threshold=3.0, min_abs_s=0.1)
        for _ in range(8):
            for h in range(8):
                sm2.record(f"h{h}", 1.0 + (0.9 if h == 7 else 0.0))
        assert sm2.stragglers() == ["h7"]
        return sm2.stragglers()

    out = _both(ref, run)
    assert out["ref"] == out["port"]


def test_straggler_forget_clears_history(ref):
    def run(pk):
        sm = pk.elastic.StragglerMonitor(threshold=3.0)
        for _ in range(8):
            for h in range(8):
                sm.record(f"h{h}", 2.0 if h == 7 else 1.0)
        assert sm.stragglers() == ["h7"]
        sm.forget("h7")
        assert sm.stragglers() == []
        return sorted(sm.history)

    out = _both(ref, run)
    assert out["ref"] == out["port"]


# --------------------------------------------------------------------- #
# the acceptance gate: kill a replica mid-churn, answers stay bit-exact
# --------------------------------------------------------------------- #

def test_kill_replica_mid_churn_bit_exact(ref, tmp_path):
    """3-replica set under interleaved insert/delete/compact/query churn
    with a deterministic fault schedule — a replica killed mid-stream, a
    delta batch dropped and another duplicated, heartbeat ejection on a
    fake clock, rejoin via checkpoint restore + log replay.  Every
    answer equals the package's single-replica oracle bit for bit, no
    request is lost or answered twice, and the two packages agree."""
    dim = 12

    def run(pk):
        rng = np.random.default_rng(11)

        def mkseq():
            return "".join(rng.choice(list(ALPHA),
                                      size=int(rng.integers(5, 12))))

        n = 60
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        seqs = [mkseq() for _ in range(n)]
        cfg = _cfg(pk)
        rs = pk.repl.ReplicaSet(vecs, seqs, cfg, n_replicas=3,
                                ckpt_dir=str(tmp_path / pk.name / "ckpt"))
        clk = FakeClock()
        inj = pk.repl.FaultInjector()
        inj.kill("r1", at_wave=6)
        inj.rejoin("r1", at_wave=14)
        inj.drop_batch(8)
        inj.duplicate_batch(11)
        router = pk.Router(rs, max_lag=4, heartbeat_timeout_s=5.0,
                           clock=clk, sleep=clk.sleep, injector=inj,
                           checkpoint_every=4)
        oracle = pk.VectorMaton(vecs.copy(), list(seqs), cfg)
        pats = ["ab", "a AND NOT cd", "LIKE '%a%b%'", "NOT ab", "cd OR b"]
        live = set(range(n))
        answers = []
        for wave in range(20):
            v = rng.standard_normal(dim).astype(np.float32)
            s = mkseq()
            vid = router.submit_insert(v, s)
            assert vid == oracle.insert(v, s)
            live.add(vid)
            if wave % 5 == 3:
                victim = sorted(live)[int(rng.integers(0, len(live)))]
                router.submit_delete(victim)
                oracle.delete(victim)
                live.discard(victim)
            if wave == 10:
                router.submit_compact()
                oracle.compact()
            q = rng.standard_normal((len(pats), dim)).astype(np.float32)
            got = router.serve_wave(q, pats, k=6)
            want = oracle.query_batch(q, pats, 6)
            for p, (gd, gi), (wd, wi) in zip(pats, got, want):
                assert gi.tolist() == wi.tolist(), (wave, p)
                assert np.array_equal(gd, wd), (wave, p)
            answers.append(got)
            clk.advance(2.0)
        router.assert_no_loss()
        st = router.router_stats()
        assert st["accepted"] == st["answered"] == 20
        assert st["rejoined"] == 1
        assert st["failovers"] >= 1
        assert st["reships"] >= 1
        r1 = rs.replicas["r1"]
        assert r1.alive and r1.serving and r1.restores == 1
        assert rs.lag(r1) <= router.max_lag
        assert all(r.applied == rs.log.tail
                   for r in rs.replicas.values() if r.alive)
        assert ("kill", 6, "r1") in inj.events
        assert ("rejoin", 14, "r1") in inj.events
        return answers, st, inj.events

    out = _both(ref, run)
    _agree(out["ref"][0], out["port"][0])
    assert out["ref"][1:] == out["port"][1:]

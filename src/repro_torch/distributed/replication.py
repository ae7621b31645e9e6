"""Replica groups + delta-log replication (DESIGN.md §10).

Port of ``src/repro/distributed/replication.py`` over the port's engine
and ``core.packed.extract_delta_records``.  Replicas restored from a
checkpoint take the configuration and device of the engine they replace
(the checkpoint records the index parameters, not where it runs), so
every replica of a set runs on the same kind of device.  A replica that
rejoins with fewer devices than it left with is resharded onto the mesh
``ElasticPlan.remesh`` picks over them (reshard-on-rejoin).

One mesh is one failure domain.  This module turns N independently
built engines into a *replica set* behind a single write leader:

  * **Write funnel.**  Every insert/delete/compact applies on the leader
    first and is appended to an ordered **delta log** — one
    ``DeltaRecord`` per write, stamped with the leader's post-apply
    (generation, delta-version) tokens from the PR 3 write path and a
    dense log sequence number (lsn).  The log tail is the *commit
    watermark*.
  * **Follower apply.**  The router ships each follower its missing log
    suffix at wave heads; ``Replica.apply`` is idempotent below the
    follower's acked watermark (duplicate ships are skipped by lsn) and
    contiguity-checked above it (a dropped batch raises
    ``ReplicationGap`` instead of silently forking history).  An insert
    whose replay lands on a different id than the leader recorded raises
    ``ReplicaDiverged`` — the id assignment is deterministic, so a
    mismatch means the replica's state forked.
  * **Determinism = bit-exactness.**  Replicas are built from the same
    inputs with the same seeds and replay the same writes in the same
    order, so every healthy replica's answers — including approximate
    HNSW beam results — are bit-identical to a single-replica
    synchronous oracle.  tests/test_fault_tolerance.py gates this under
    injected kills, drops, duplicates, and rejoins.
  * **Recovery substrate.**  ``ReplicaSet.checkpoint`` saves the
    leader's index with the log watermark as sidecar meta
    (``save_vectormaton(extra_meta=...)``); ``restore_replica`` restores
    a dead replica from the newest checkpoint and the router replays the
    log suffix past the checkpoint's lsn.  When the rejoiner comes back
    with fewer devices, ``ElasticPlan.remesh`` picks the largest viable
    mesh for the restored engine (reshard-on-rejoin).  ``truncate_log``
    bounds log memory: records at or below min(checkpoint lsn, every
    serving replica's ack) can never be replayed again.

``FaultInjector`` drives all of it deterministically — faults fire on
wave indexes and ship counters, never on wall time or randomness, so a
failing churn schedule replays identically under pytest.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .checkpoint import load_checkpoint_meta
from .elastic import ElasticPlan


class ReplicaDead(RuntimeError):
    """The addressed replica is down (fault-injected or crashed)."""


class ReplicaStalled(RuntimeError):
    """The addressed replica is unresponsive but not known dead — the
    heartbeat path, not the exception path, decides its fate."""


class ReplicationGap(RuntimeError):
    """A shipped batch does not extend the follower's acked watermark
    contiguously — a batch was lost in flight; resend from the ack."""


class ReplicaDiverged(RuntimeError):
    """Replaying a record produced a different result than the leader
    recorded: the replica's state forked and must be rebuilt."""


class NoHealthyReplica(RuntimeError):
    """Every replica is dead or ineligible; the wave cannot be served."""


@dataclass
class DeltaRecord:
    """One replicated write.  ``generation``/``delta_version`` are the
    leader's PR 3 write-path stamps *after* applying the op — followers
    validate that shipped batches never regress them."""
    lsn: int
    op: str                            # 'insert' | 'delete' | 'compact'
    generation: int = -1
    delta_version: int = -1
    vector: Optional[np.ndarray] = None
    sequence: Optional[object] = None
    attributes: Optional[dict] = None
    vector_id: int = -1                # assigned (insert) / target (delete)


class DeltaLog:
    """Ordered, truncatable write log.  lsns are dense and 1-based;
    ``tail`` is the commit watermark, ``floor`` the highest truncated
    lsn (a follower whose ack is below the floor cannot be caught up
    from the log and must restore a checkpoint first)."""

    def __init__(self) -> None:
        self._records: List[DeltaRecord] = []
        self.floor = 0                 # records with lsn <= floor dropped

    @property
    def tail(self) -> int:
        return self.floor + len(self._records)

    def append(self, record: DeltaRecord) -> DeltaRecord:
        if record.lsn != self.tail + 1:
            raise ValueError(
                f"log append out of order: lsn {record.lsn}, "
                f"tail {self.tail}")
        self._records.append(record)
        return record

    def batch(self, since: int, upto: Optional[int] = None
              ) -> List[DeltaRecord]:
        """Records with ``since < lsn <= upto`` (default: tail)."""
        upto = self.tail if upto is None else upto
        if since < self.floor:
            raise ReplicationGap(
                f"log truncated past lsn {since} (floor {self.floor}): "
                f"catch up from a checkpoint")
        lo = max(0, since - self.floor)
        hi = max(lo, upto - self.floor)
        return self._records[lo:hi]

    def truncate(self, below: int) -> int:
        """Drop records with ``lsn <= below``; returns dropped count."""
        n = min(max(0, below - self.floor), len(self._records))
        if n:
            del self._records[:n]
            self.floor += n
        return n

    def __len__(self) -> int:
        return len(self._records)


class Replica:
    """One engine behind the router: liveness flags, the acked
    watermark, and the idempotent/contiguity-checked batch apply."""

    def __init__(self, name: str, engine, devices=None):
        self.name = name
        self.engine = engine
        self.devices = list(devices) if devices is not None else None
        self.alive = True
        self.serving = True            # admitted to the read pool
        self.applied = 0               # acked watermark (highest lsn)
        self.waves_served = 0
        self.batches_applied = 0
        self.restores = 0

    def kill(self) -> None:
        """The process dies.  ``serving`` — the ROUTER's belief — is
        deliberately left alone: the router only learns of the death
        through a failed ship/serve or heartbeat silence, which is the
        failover machinery under test."""
        self.alive = False

    def apply(self, records: Sequence[DeltaRecord]) -> int:
        """Apply a shipped batch (a wave-head barrier on this replica).
        Returns the acked watermark.  Duplicates (lsn <= ack) are
        skipped; a gap above the ack raises ``ReplicationGap``; a
        divergent insert-id raises ``ReplicaDiverged``."""
        if not self.alive:
            raise ReplicaDead(self.name)
        for rec in records:
            if rec.lsn <= self.applied:
                continue                       # duplicate ship: idempotent
            if rec.lsn != self.applied + 1:
                raise ReplicationGap(
                    f"{self.name}: batch jumps to lsn {rec.lsn} with "
                    f"ack at {self.applied} (a batch was dropped)")
            if rec.op == "insert":
                got = self.engine.insert(rec.vector, rec.sequence,
                                         attributes=rec.attributes)
                if got != rec.vector_id:
                    raise ReplicaDiverged(
                        f"{self.name}: replayed insert lsn {rec.lsn} "
                        f"landed on id {got}, leader recorded "
                        f"{rec.vector_id}")
            elif rec.op == "delete":
                self.engine.delete(rec.vector_id)
            elif rec.op == "compact":
                self.engine.compact()
            else:
                raise ValueError(f"unknown delta op {rec.op!r}")
            self.applied = rec.lsn
        if records:
            self.batches_applied += 1
        return self.applied

    def serve_wave(self, queries: np.ndarray, patterns: Sequence, k: int,
                   ef_search: int = 64):
        if not self.alive:
            raise ReplicaDead(self.name)
        out = self.engine.query_batch(queries, patterns, k,
                                      ef_search=ef_search)
        self.waves_served += 1
        return out


class FaultInjector:
    """Deterministic fault schedule for the replicated serving loop.

    Everything keys off integer counters the router advances — wave
    indexes and the global ship counter — never wall time or RNG state,
    so a schedule replays bit-identically.

      * ``kill(name, at_wave)`` — the replica drops dead at that wave's
        head (the router only learns via failed ships/serves or
        heartbeat silence).
      * ``rejoin(name, at_wave)`` — the replica asks to rejoin at that
        wave's head (checkpoint restore + log replay).
      * ``stall(name, from_wave, until_wave)`` — ships and serves raise
        ``ReplicaStalled`` in [from, until); the replica stops beating
        and the heartbeat monitor is what ejects it.
      * ``delay(name, at_wave, seconds)`` — the replica answers, but its
        recorded serve time is inflated (straggler-detection fodder).
      * ``drop_batch(nth)`` / ``duplicate_batch(nth)`` — the nth shipped
        batch (1-based, global counter) is lost / delivered twice.
    """

    def __init__(self) -> None:
        self._kills: Dict[int, List[str]] = {}
        self._rejoins: Dict[int, List[str]] = {}
        self._stalls: Dict[str, List[Tuple[int, int]]] = {}
        self._delays: Dict[Tuple[str, int], float] = {}
        self._drop: set = set()
        self._dup: set = set()
        self.ships = 0
        self.events: List[Tuple] = []      # audit trail (what fired when)

    # -- schedule -------------------------------------------------------- #
    def kill(self, name: str, at_wave: int) -> None:
        self._kills.setdefault(at_wave, []).append(name)

    def rejoin(self, name: str, at_wave: int) -> None:
        self._rejoins.setdefault(at_wave, []).append(name)

    def stall(self, name: str, from_wave: int, until_wave: int) -> None:
        self._stalls.setdefault(name, []).append((from_wave, until_wave))

    def delay(self, name: str, at_wave: int, seconds: float) -> None:
        self._delays[(name, at_wave)] = seconds

    def drop_batch(self, nth: int) -> None:
        self._drop.add(nth)

    def duplicate_batch(self, nth: int) -> None:
        self._dup.add(nth)

    # -- runtime hooks ---------------------------------------------------- #
    def on_wave(self, wave: int, replicas: Dict[str, Replica]
                ) -> List[str]:
        """Fire the wave-head schedule; returns names asking to rejoin."""
        for name in self._kills.pop(wave, []):
            if name in replicas:
                replicas[name].kill()
                self.events.append(("kill", wave, name))
        rejoins = self._rejoins.pop(wave, [])
        for name in rejoins:
            self.events.append(("rejoin", wave, name))
        return rejoins

    def stalled(self, name: str, wave: int) -> bool:
        return any(lo <= wave < hi for lo, hi in self._stalls.get(name, []))

    def serve_delay(self, name: str, wave: int) -> float:
        return self._delays.pop((name, wave), 0.0)

    def filter_batch(self, records: List[DeltaRecord]
                     ) -> List[DeltaRecord]:
        """Route one shipped batch through the drop/duplicate schedule."""
        if not records:
            return records
        self.ships += 1
        if self.ships in self._drop:
            self.events.append(("drop_batch", self.ships))
            return []
        if self.ships in self._dup:
            self.events.append(("duplicate_batch", self.ships))
            return list(records) + list(records)
        return records


class ReplicaSet:
    """N bit-identical engine replicas + the shared delta log.

    Replicas are built by replaying the leader's construction — same
    vectors, sequences, config, and seeds — so their indexes (including
    HNSW topology) are identical, and identical op replay keeps them
    identical.  All policy (routing, retries, heartbeats, rejoin
    orchestration) lives in ``serve.router.ReplicatedRouter``; this
    class owns state: replicas, log, leadership, checkpoints.
    """

    def __init__(self, vectors: np.ndarray, sequences: Sequence,
                 config=None, n_replicas: int = 2, attributes=None,
                 ckpt_dir: Optional[str] = None,
                 engine_factory: Optional[Callable[[], object]] = None,
                 names: Optional[Sequence[str]] = None):
        from ..serve.engine import RetrievalEngine
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        names = list(names) if names is not None else [
            f"r{i}" for i in range(n_replicas)]
        if len(names) != n_replicas:
            raise ValueError("names must match n_replicas")
        self._factory = engine_factory or (
            lambda: RetrievalEngine(vectors, sequences, config,
                                    attributes=attributes))
        self.replicas: "OrderedDict[str, Replica]" = OrderedDict()
        for name in names:
            self.replicas[name] = Replica(name, self._factory())
        self.leader_name = names[0]
        self.log = DeltaLog()
        self.ckpt_dir = ckpt_dir
        self.checkpoints: Dict[int, str] = {}      # lsn -> path
        self.writes_accepted = 0

    # ------------------------------------------------------------------ #
    @classmethod
    def from_engine(cls, engine, n_replicas: int = 2,
                    ckpt_dir: Optional[str] = None,
                    names: Optional[Sequence[str]] = None) -> "ReplicaSet":
        """Attach replication to an engine that is already serving.

        The engine becomes the leader as-is.  Writes it absorbed before
        replication attached — the unfolded delta of its current
        generation plus its live tombstones — are extracted
        (``core.packed.extract_delta_records``) and seeded into the log,
        so the commit watermark reflects them; followers bootstrap from
        an attach-time checkpoint that acks the seeded watermark."""
        from ..core.packed import extract_delta_records
        if ckpt_dir is None:
            raise ValueError("from_engine needs ckpt_dir (followers "
                             "bootstrap from an attach-time checkpoint)")
        self = cls.__new__(cls)
        names = list(names) if names is not None else [
            f"r{i}" for i in range(n_replicas)]
        self._factory = None
        self.replicas = OrderedDict()
        self.replicas[names[0]] = Replica(names[0], engine)
        self.leader_name = names[0]
        self.log = DeltaLog()
        self.ckpt_dir = ckpt_dir
        self.checkpoints = {}
        self.writes_accepted = 0
        gen, ver = engine.replication_token()
        cfg = engine.index.config
        for payload in extract_delta_records(engine.index):
            rec = DeltaRecord(lsn=self.log.tail + 1,
                              generation=gen, delta_version=ver, **payload)
            self.log.append(rec)
        self.leader.applied = self.log.tail
        lsn, path = self.checkpoint()
        from ..serve.engine import RetrievalEngine
        for name in names[1:]:
            r = Replica(name, RetrievalEngine.restore(
                path, config=cfg, device=cfg.device))
            r.applied = lsn
            r.restores += 1
            self.replicas[name] = r
        return self

    # ------------------------------------------------------------------ #
    @property
    def leader(self) -> Replica:
        return self.replicas[self.leader_name]

    def healthy(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.alive and r.serving]

    def promote(self, name: str) -> Replica:
        """Leader failover: the new leader first replays the log suffix
        it is missing (the log, not the dead leader, is the write
        history of record), then takes the write funnel."""
        r = self.replicas[name]
        if not r.alive:
            raise ReplicaDead(name)
        r.apply(self.log.batch(r.applied))
        self.leader_name = name
        return r

    # ------------------------------------------------------------------ #
    # write funnel
    # ------------------------------------------------------------------ #
    def apply_write(self, op: str, *, vector=None, sequence=None,
                    attributes=None, vector_id: int = -1
                    ) -> Tuple[DeltaRecord, object]:
        """Apply one write on the leader and append its stamped record.
        Returns (record, result) where result is the assigned id
        (insert), the echoed id (delete), or the new generation
        (compact)."""
        lead = self.leader
        if not lead.alive:
            raise ReplicaDead(self.leader_name)
        if lead.applied != self.log.tail:
            # a just-promoted leader must be at the tail before writing
            lead.apply(self.log.batch(lead.applied))
        if op == "insert":
            vec = np.array(np.asarray(vector, dtype=np.float32))
            result = lead.engine.insert(vec, sequence,
                                        attributes=attributes)
            vector_id = int(result)
        elif op == "delete":
            lead.engine.delete(int(vector_id))
            result = int(vector_id)
            vec, sequence, attributes = None, None, None
        elif op == "compact":
            lead.engine.compact()
            result = lead.engine.replication_token()[0]
            vec, sequence, attributes = None, None, None
        else:
            raise ValueError(f"unknown write op {op!r}")
        gen, ver = lead.engine.replication_token()
        rec = self.log.append(DeltaRecord(
            lsn=self.log.tail + 1, op=op, generation=gen,
            delta_version=ver, vector=vec, sequence=sequence,
            attributes=attributes, vector_id=vector_id))
        lead.applied = rec.lsn
        self.writes_accepted += 1
        return rec, result

    def ship(self, replica: Replica, upto: Optional[int] = None,
             injector: Optional[FaultInjector] = None) -> int:
        """Ship ``replica`` its missing log suffix (through the fault
        injector when one is wired).  Returns the acked watermark — a
        dropped batch leaves it short; the router re-ships."""
        want = self.log.tail if upto is None else upto
        if replica.applied >= want:
            if replica.alive:
                return replica.applied
            raise ReplicaDead(replica.name)
        records = self.log.batch(replica.applied, want)
        if injector is not None:
            records = injector.filter_batch(records)
        return replica.apply(records)

    # ------------------------------------------------------------------ #
    # checkpoints + rejoin
    # ------------------------------------------------------------------ #
    def checkpoint(self, path: Optional[str] = None) -> Tuple[int, str]:
        """Save the leader's index stamped with the current commit
        watermark.  A rejoiner restores the newest of these and replays
        records past its lsn."""
        if path is None:
            if self.ckpt_dir is None:
                raise ValueError("no ckpt_dir configured")
            os.makedirs(self.ckpt_dir, exist_ok=True)
            path = os.path.join(self.ckpt_dir,
                                f"replica_ckpt_{self.log.tail:010d}")
        lead = self.leader
        lsn = self.log.tail
        gen, ver = lead.engine.replication_token()
        lead.engine.checkpoint(path, extra_meta={
            "lsn": lsn, "generation": gen, "delta_version": ver})
        self.checkpoints[lsn] = path
        return lsn, path

    def latest_checkpoint(self) -> Optional[Tuple[int, str]]:
        if not self.checkpoints:
            return None
        lsn = max(self.checkpoints)
        return lsn, self.checkpoints[lsn]

    def restore_replica(self, name: str,
                        devices: Optional[Sequence] = None) -> Replica:
        """Rebuild a dead replica from the newest checkpoint (taking one
        now if none exists).  The replica comes back alive but NOT
        serving — the router replays the log suffix and readmits it only
        once it is within the staleness bound.

        ``devices``: the chips the rejoiner returned with.  When it
        shrank below what it left with, ``ElasticPlan`` picks the
        largest viable (data, model) mesh over the survivors and the
        restored engine is resharded onto it (reshard-on-rejoin)."""
        from ..serve.engine import RetrievalEngine
        old = self.replicas[name]
        ck = self.latest_checkpoint()
        if ck is None:
            ck = self.checkpoint()
        lsn, path = ck
        mesh = None
        if devices is not None:
            prev = len(old.devices) if old.devices is not None \
                else len(devices)
            if old.devices is not None and len(devices) < prev:
                mesh = ElasticPlan(
                    tp_degree=1, old_data=prev).remesh(devices)
            elif getattr(old.engine, "mesh", None) is not None:
                mesh = old.engine.mesh
        cfg = old.engine.index.config
        engine = RetrievalEngine.restore(path, mesh=mesh, config=cfg,
                                         device=cfg.device)
        meta = load_checkpoint_meta(path)
        r = Replica(name, engine,
                    devices=devices if devices is not None
                    else old.devices)
        r.applied = int(meta.get("lsn", lsn))
        r.serving = False
        r.restores = old.restores + 1
        self.replicas[name] = r
        return r

    def truncate_log(self) -> int:
        """Drop records that can never be replayed again: everything at
        or below min(newest checkpoint lsn, every live replica's ack).
        Dead replicas don't hold the log — they rejoin via checkpoint
        restore, which only replays records past the checkpoint lsn."""
        acks = [r.applied for r in self.replicas.values() if r.alive]
        ck = self.latest_checkpoint()
        floor_candidates = acks + ([ck[0]] if ck is not None else [])
        if not floor_candidates or ck is None:
            return 0
        return self.log.truncate(min(floor_candidates))

    # ------------------------------------------------------------------ #
    def lag(self, replica: Replica) -> int:
        return self.log.tail - replica.applied

    def stats(self) -> Dict[str, object]:
        return {
            "commit_lsn": self.log.tail,
            "log_len": len(self.log),
            "log_floor": self.log.floor,
            "leader": self.leader_name,
            "writes_accepted": self.writes_accepted,
            "replicas": {
                name: {"alive": r.alive, "serving": r.serving,
                       "applied": r.applied, "lag": self.lag(r),
                       "waves_served": r.waves_served,
                       "restores": r.restores}
                for name, r in self.replicas.items()},
        }


__all__ = ["ReplicaDead", "ReplicaStalled", "ReplicationGap",
           "ReplicaDiverged", "NoHealthyReplica", "DeltaRecord", "DeltaLog",
           "Replica", "FaultInjector", "ReplicaSet"]

"""Replicated serving router: read scaling, bounded staleness, failover
(DESIGN.md §10).

Port of ``src/repro/serve/router.py`` (``ReplicatedRouter``): pure policy
over the port's ``distributed.replication.ReplicaSet``; the replicas'
engines run where their configuration says (the card by default).  One
change: a replica's serve time, which feeds the straggler monitor, is
read on the injectable ``clock`` like every other liveness input (the
reference read ``time.perf_counter``), so a fault schedule on a fake
clock replays identically however loaded the host is.

``ReplicatedRouter`` sits in front of a ``distributed.replication
.ReplicaSet`` and owns all *policy*:

  * **Writes** funnel to the write leader (``ReplicaSet.apply_write``);
    a dead leader is replaced in-line by promoting the healthiest
    survivor — the one with the highest applied watermark — which
    replays the log suffix it is missing before taking the funnel.
  * **Reads** fan out: at every wave head the router ships each live
    replica its missing delta-log suffix (the ship doubles as the
    heartbeat carrier — a successful apply is a beat), sweeps the
    ``HeartbeatMonitor``, ejects replicas silent for 2x the timeout,
    then round-robins the wave over the *eligible* pool.

  * **Bounded staleness, exact answers.**  ``max_lag`` governs routing
    *eligibility* only: a replica more than ``max_lag`` delta-versions
    behind the commit watermark is skipped (it would need a large
    catch-up burst at the wave head).  The replica actually chosen is
    always shipped to the full commit watermark before it answers, so
    every answer is computed at the complete accepted-write prefix —
    bit-identical to a single-replica synchronous oracle, which is what
    the churn gate in tests/test_fault_tolerance.py asserts.

  * **Failover.**  A serve that hits a dead/stalled replica retries the
    wave on the next survivor under capped exponential backoff (the
    sleep is injectable, so tests assert the exact backoff sequence).
    Every accepted wave is answered exactly once — ``assert_no_loss``
    audits the ledger.

  * **Rejoin.**  An ejected replica comes back through
    ``ReplicaSet.restore_replica`` (newest leader checkpoint, possibly
    resharded onto a smaller device set via ``ElasticPlan.remesh``),
    replays the log past the checkpoint's lsn, and is readmitted to the
    read pool only once its lag is within ``max_lag``.  A
    ``checkpoint_every`` cadence keeps restore points fresh and lets
    ``truncate_log`` bound log memory.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed.elastic import HeartbeatMonitor, StragglerMonitor
from ..distributed.replication import (FaultInjector, NoHealthyReplica,
                                       Replica, ReplicaDead, ReplicaSet,
                                       ReplicaStalled, ReplicationGap)


class ReplicatedRouter:
    """Policy layer over a ``ReplicaSet``.  Deterministic by
    construction: the only clocks are the injectable ``clock`` (liveness
    decisions) and ``sleep`` (backoff), and the only fault source is the
    ``FaultInjector`` — a failing schedule replays identically."""

    def __init__(self, replica_set: ReplicaSet, max_lag: int = 8,
                 heartbeat_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 injector: Optional[FaultInjector] = None,
                 checkpoint_every: Optional[int] = None,
                 max_retries: int = 4,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 straggler_threshold: float = 3.0,
                 straggler_min_abs_s: float = 0.1,
                 straggler_max_age_s: Optional[float] = None):
        self.rs = replica_set
        self.max_lag = int(max_lag)
        self.clock = clock
        self.sleep = sleep
        self.injector = injector
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.hb = HeartbeatMonitor(
            [r.name for r in replica_set.replicas.values() if r.alive],
            timeout_s=heartbeat_timeout_s, clock=clock)
        self.stragglers = StragglerMonitor(
            threshold=straggler_threshold,
            min_abs_s=straggler_min_abs_s,
            max_age_s=straggler_max_age_s, clock=clock)
        self.wave = 0                    # wave-head counter (1-based)
        self._rr = 0                     # round-robin cursor
        self._accepted = 0               # read waves admitted
        self._answered: List[int] = []   # wave ids answered (audit)
        self.stats: Dict[str, int] = {
            "waves": 0, "failovers": 0, "retries": 0, "ejected": 0,
            "rejoined": 0, "leader_promotions": 0, "reships": 0,
            "straggler_skips": 0, "checkpoints": 0,
        }

    # ------------------------------------------------------------------ #
    # write funnel (leader, with in-line promotion on leader death)
    # ------------------------------------------------------------------ #
    def _ensure_leader(self) -> Replica:
        lead = self.rs.leader
        if lead.alive:
            return lead
        live = [r for r in self.rs.replicas.values() if r.alive]
        if not live:
            raise NoHealthyReplica("write rejected: no live replica "
                                   "to promote")
        # healthiest survivor = highest applied watermark (least replay)
        new = max(live, key=lambda r: (r.applied, r.name))
        self.rs.promote(new.name)
        self.stats["leader_promotions"] += 1
        self.stats["failovers"] += 1
        return new

    def submit_insert(self, vector, sequence, attributes=None) -> int:
        self._ensure_leader()
        _, vid = self.rs.apply_write("insert", vector=vector,
                                     sequence=sequence,
                                     attributes=attributes)
        return int(vid)

    def submit_delete(self, vector_id: int) -> None:
        self._ensure_leader()
        self.rs.apply_write("delete", vector_id=vector_id)

    def submit_compact(self) -> None:
        self._ensure_leader()
        self.rs.apply_write("compact")

    # ------------------------------------------------------------------ #
    # wave head: faults -> ships/heartbeats -> ejection -> checkpoints
    # ------------------------------------------------------------------ #
    def _wave_head(self) -> None:
        self.wave += 1
        if self.injector is not None:
            for name in self.injector.on_wave(self.wave,
                                              self.rs.replicas):
                self.rejoin(name)
        self._ship_all()
        now = self.clock()
        verdict = self.hb.check(now=now)
        for name, state in verdict.items():
            r = self.rs.replicas.get(name)
            if state == "dead" and r is not None and r.serving:
                r.serving = False           # ejected from the read pool
                self.stragglers.forget(name)
                self.stats["ejected"] += 1
        if (self.checkpoint_every is not None
                and self.wave % self.checkpoint_every == 0
                and self.rs.leader.alive):
            self.rs.checkpoint()
            self.rs.truncate_log()
            self.stats["checkpoints"] += 1

    def _ship_all(self) -> None:
        """Ship every live replica its missing suffix.  A successful
        apply is that replica's heartbeat; a dropped batch leaves the
        ack short and is re-shipped (bounded), counted in ``reships``."""
        now = self.clock()
        for r in list(self.rs.replicas.values()):
            if not r.alive:
                continue
            if (self.injector is not None
                    and self.injector.stalled(r.name, self.wave)):
                continue                    # no apply, no beat: silence
            try:
                ack = self.rs.ship(r, injector=self.injector)
                for _ in range(self.max_retries):
                    if ack >= self.rs.log.tail:
                        break
                    self.stats["reships"] += 1
                    ack = self.rs.ship(r, injector=self.injector)
                self.hb.beat(r.name, now=now)
            except ReplicaDead:
                pass                        # silence -> heartbeat path
            except ReplicationGap:
                # batch lost mid-suffix: resend the whole suffix from
                # the replica's (unchanged) ack
                self.stats["reships"] += 1
                try:
                    self.rs.ship(r, injector=self.injector)
                    self.hb.beat(r.name, now=now)
                except (ReplicaDead, ReplicationGap):
                    pass

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #
    def _eligible(self) -> List[Replica]:
        # routing goes by the router's BELIEF (``serving``), never by
        # ground-truth ``alive`` — a freshly-dead replica stays in the
        # pool until a failed serve or heartbeat silence ejects it,
        # which is exactly the failover path under test
        pool = [r for r in self.rs.replicas.values()
                if r.serving and self.rs.lag(r) <= self.max_lag]
        slow = set(self.stragglers.stragglers(now=self.clock()))
        fast = [r for r in pool if r.name not in slow]
        if slow and fast:
            self.stats["straggler_skips"] += len(pool) - len(fast)
            pool = fast
        if not pool:
            # bounded-staleness fallback: the leader always qualifies
            # (it IS the commit watermark); if the leader itself died,
            # promote a survivor first — reads must not starve while the
            # write funnel is idle
            try:
                lead = self._ensure_leader()
            except NoHealthyReplica:
                return []
            if lead.serving:
                pool = [lead]
        return pool

    def serve_wave(self, queries: np.ndarray, patterns: Sequence,
                   k: int, ef_search: int = 64
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Serve one query wave on some healthy replica, retrying over
        survivors with capped exponential backoff.  The chosen replica
        is always caught up to the commit watermark captured at the
        wave head before it answers (exactness; ``max_lag`` only gates
        which replicas are *candidates*)."""
        self._wave_head()
        wave_id = self._accepted
        self._accepted += 1
        required = self.rs.log.tail      # commit watermark for this wave
        attempt = 0
        while True:
            pool = self._eligible()
            if not pool:
                raise NoHealthyReplica(
                    f"wave {self.wave}: no live replica within "
                    f"max_lag={self.max_lag} and no live leader")
            r = pool[self._rr % len(pool)]
            self._rr += 1
            try:
                if (self.injector is not None
                        and self.injector.stalled(r.name, self.wave)):
                    raise ReplicaStalled(r.name)
                if r.applied < required:
                    self.rs.ship(r, upto=required,
                                 injector=self.injector)
                    if r.applied < required:      # dropped batch: once more
                        self.stats["reships"] += 1
                        self.rs.ship(r, upto=required,
                                     injector=self.injector)
                    if r.applied < required:
                        raise ReplicaStalled(
                            f"{r.name}: cannot reach watermark "
                            f"{required} (ack {r.applied})")
                # serve time on the injectable clock: the reference timed
                # it with perf_counter, so a slow host under load could
                # flip straggler routing and break replayability
                t0 = self.clock()
                out = r.serve_wave(np.asarray(queries, np.float32),
                                   patterns, k, ef_search=ef_search)
                dt = self.clock() - t0
                if self.injector is not None:
                    dt += self.injector.serve_delay(r.name, self.wave)
                self.stragglers.record(r.name, dt, now=self.clock())
                self._answered.append(wave_id)
                self.stats["waves"] += 1
                return out
            except (ReplicaDead, ReplicaStalled, ReplicationGap) as e:
                if isinstance(e, ReplicaDead):
                    # an observed failure IS how the router learns of a
                    # death: eject from the read pool immediately
                    if r.serving:
                        r.serving = False
                        self.stragglers.forget(r.name)
                        self.stats["ejected"] += 1
                # stalled/gapped replicas stay pooled — the heartbeat
                # sweep decides their fate; this wave just routes around
                attempt += 1
                self.stats["retries"] += 1
                self.stats["failovers"] += 1
                if attempt > self.max_retries:
                    raise NoHealthyReplica(
                        f"wave {self.wave}: exhausted {self.max_retries}"
                        f" retries") from None
                self.sleep(min(self.backoff_cap_s,
                               self.backoff_base_s * (2 ** (attempt - 1))))

    # ------------------------------------------------------------------ #
    # rejoin
    # ------------------------------------------------------------------ #
    def rejoin(self, name: str,
               devices: Optional[Sequence] = None) -> Replica:
        """Bring a dead replica back: restore the newest leader
        checkpoint (resharded via ``ElasticPlan`` if the rejoiner
        returned with fewer devices), replay the delta-log suffix past
        the checkpoint's lsn, and readmit to the read pool only once
        within ``max_lag`` of the commit watermark."""
        r = self.rs.restore_replica(name, devices=devices)
        self.rs.ship(r)                  # replay suffix (no injector:
        #                                  recovery traffic is reliable —
        #                                  it is pull-based, not a ship)
        if self.rs.lag(r) > self.max_lag:
            raise ReplicaStalled(
                f"{name}: rejoin replay left lag {self.rs.lag(r)} "
                f"> max_lag {self.max_lag}")
        r.serving = True
        self.hb.add_host(name, now=self.clock())
        self.stragglers.forget(name)
        self.stats["rejoined"] += 1
        return r

    # ------------------------------------------------------------------ #
    # audit
    # ------------------------------------------------------------------ #
    def assert_no_loss(self) -> None:
        """Every accepted read wave answered exactly once, in order; no
        write lost (commit watermark covers every accepted write)."""
        if self._answered != list(range(self._accepted)):
            dup = len(self._answered) - len(set(self._answered))
            missing = set(range(self._accepted)) - set(self._answered)
            raise AssertionError(
                f"request ledger violated: {dup} duplicate answer(s), "
                f"missing wave ids {sorted(missing)}")

    def router_stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.stats)
        out["accepted"] = self._accepted
        out["answered"] = len(self._answered)
        out.update(self.rs.stats())
        return out


__all__ = ["ReplicatedRouter"]

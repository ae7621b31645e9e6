"""Fault-tolerance runtime: heartbeats, straggler mitigation, elastic
re-meshing.

Port of ``src/repro/distributed/elastic.py``: ``HeartbeatMonitor``,
``StragglerMonitor`` and ``ElasticPlan.plan`` are pure Python and
copied; ``ElasticPlan.remesh`` builds the port's ``launch.mesh.Mesh``.

On a real multi-pod deployment these hooks bind to the cluster manager
(GKE / Borg preemption notices, ICI link telemetry).  The logic — which is
what can be validated off-hardware — is pure Python over step timings and
a device-health table, and is exercised by tests/test_fault_tolerance.py:

  * `HeartbeatMonitor` — per-host liveness with configurable timeout;
    one silent window marks the host suspect, two mark it dead.
  * `StragglerMonitor` — robust (median + MAD) per-step outlier detection;
    the launcher consults `should_checkpoint_and_rebalance()` to decide
    when a slow host warrants a backup-worker dispatch or re-mesh.
  * `ElasticPlan` — given the surviving device set, picks the largest
    (data, model) mesh that preserves the TP degree, and drives
    CheckpointManager.restore(..., sharding_tree=new) — reshard-on-load.

The train loop (launch/train.py) wires these around every step, and the
replicated serving router (serve/router.py, DESIGN.md §10) wires them
around every wave; the checkpoint manager provides the recovery
substrate.  Both monitors take an injectable ``clock`` so decision logic
never reads the wall clock directly — the serving failover tests drive
them with a fake clock and replay identical fault schedules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HeartbeatMonitor:
    """Liveness by elapsed silence: a host that has not beaten for one
    ``timeout_s`` window is suspect, for two it is dead.  The verdict
    depends only on (now - last_seen) — NOT on how often ``check`` is
    called.  (The previous implementation restarted the window at every
    check that found it expired, so a silent host needed one check per
    window plus ~2× timeout of wall time to be declared dead, and with
    sparse checks could stay "suspect" forever.)"""

    def __init__(self, hosts: Sequence[str], timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.time):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen: Dict[str, float] = {h: clock() for h in hosts}
        self.suspect: Dict[str, int] = {h: 0 for h in hosts}

    def add_host(self, host: str, now: Optional[float] = None) -> None:
        """(Re)admit a host: its silence window starts fresh."""
        self.last_seen[host] = self.clock() if now is None else now
        self.suspect[host] = 0

    def remove_host(self, host: str) -> None:
        self.last_seen.pop(host, None)
        self.suspect.pop(host, None)

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last_seen[host] = self.clock() if now is None else now
        self.suspect[host] = 0

    def check(self, now: Optional[float] = None) -> Dict[str, str]:
        now = self.clock() if now is None else now
        out = {}
        for h, t in self.last_seen.items():
            missed = int(max(0.0, now - t) // self.timeout_s)
            self.suspect[h] = missed
            out[h] = ("ok" if missed == 0
                      else "suspect" if missed == 1 else "dead")
        return out

    def dead_hosts(self) -> List[str]:
        return [h for h, n in self.suspect.items() if n >= 2]


class StragglerMonitor:
    """Median + MAD outlier detection over per-host step times.

    ``max_age_s`` (with an injectable ``clock``) ages samples out of the
    decision window, so a host that was slow an hour ago but has since
    recovered — or rejoined after a failover — is not flagged on stale
    history.  ``None`` keeps the pure last-``window``-samples behavior."""

    def __init__(self, threshold: float = 3.0, window: int = 16,
                 max_age_s: Optional[float] = None,
                 min_abs_s: float = 0.0,
                 clock: Callable[[], float] = time.time):
        self.threshold = threshold
        self.window = window
        self.max_age_s = max_age_s
        # absolute slack: a host is only a straggler if it is at least
        # this much slower than the fleet median.  Relative (MAD-based)
        # detection alone misfires on µs-scale timing noise when every
        # host is fast — real stragglers are *seconds* behind.
        self.min_abs_s = min_abs_s
        self.clock = clock
        # host -> [(record time, step seconds)]
        self.history: Dict[str, List[Tuple[float, float]]] = {}

    def record(self, host: str, step_time_s: float,
               now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        self.history.setdefault(host, []).append((now, step_time_s))
        self.history[host] = self.history[host][-self.window:]

    def forget(self, host: str) -> None:
        """Drop a host's history (ejection/rejoin: old samples must not
        poison the fresh incarnation's verdict)."""
        self.history.pop(host, None)

    def _recent(self, xs: List[Tuple[float, float]],
                now: float) -> List[float]:
        if self.max_age_s is None:
            return [v for _, v in xs]
        return [v for t, v in xs if now - t <= self.max_age_s]

    def _median(self, xs: Sequence[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def stragglers(self, now: Optional[float] = None) -> List[str]:
        if len(self.history) < 2:
            return []
        now = self.clock() if now is None else now
        recents = {h: self._median(vs) for h, xs in self.history.items()
                   for vs in [self._recent(xs, now)] if vs}
        if len(recents) < 2:
            return []
        med = self._median(list(recents.values()))
        mad = self._median([abs(v - med) for v in recents.values()]) + 1e-9
        return [h for h, v in recents.items()
                if (v - med) / (1.4826 * mad) > self.threshold
                and v > 1.05 * med and v - med >= self.min_abs_s]

    def should_checkpoint_and_rebalance(self,
                                        now: Optional[float] = None) -> bool:
        return bool(self.stragglers(now=now))


@dataclass
class ElasticPlan:
    """Re-mesh policy after losing devices: keep TP degree (param layout
    survives), shrink DP; batch is re-split over the survivors."""
    tp_degree: int
    old_data: int

    def plan(self, surviving_devices: int) -> Tuple[int, int]:
        if surviving_devices < self.tp_degree:
            raise RuntimeError(
                f"cannot keep tp={self.tp_degree} with "
                f"{surviving_devices} devices")
        new_data = surviving_devices // self.tp_degree
        # largest power-of-two DP not exceeding survivors/tp keeps the
        # global batch divisible
        p = 1
        while p * 2 <= new_data:
            p *= 2
        return (p, self.tp_degree)

    def remesh(self, devices):
        """A ``(data, model)`` mesh of shape ``plan(len(devices))`` over
        the first ``data · model`` of ``devices`` (``torch.device`` objects
        or their names; one device may repeat)."""
        from ..launch.mesh import Mesh
        data, model = self.plan(len(devices))
        dev = np.empty(data * model, dtype=object)
        dev[:] = list(devices)[:data * model]
        return Mesh(dev.reshape(data, model), ("data", "model"))


__all__ = ["HeartbeatMonitor", "StragglerMonitor", "ElasticPlan"]

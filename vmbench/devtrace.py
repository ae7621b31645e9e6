"""Reading a ``torch.profiler`` trace: the device's busy time, kernel
time by name, and the device's idle time by what the host was doing.

The harness keeps host spans of its own (``vmbench.*``) around the
calls it makes into the batcher, and around the engine's three stages
(``engine.*``, on the batcher's threads); an idle stretch of the device
is labelled by the latest-opened of those spans still open at its
middle, or ``host`` when none is.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW_SPAN = "vmbench.window"


@dataclass
class ProfileRecord:
    window_s: float                      # the traced window's length
    busy_s: Optional[float]              # union of device activity
    kernels: Dict[str, Tuple[float, int]]   # name -> (seconds, launches)
    idle_by_span: Dict[str, float]
    waves: List[dict] = field(default_factory=list)

    def kernel_seconds(self, parts: Sequence[str]) -> float:
        """Device seconds of the kernels whose names contain a part."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(p in name for p in parts))

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:80], s] for name, (s, _) in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        top = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s] for name, s in top]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def read_profile(prof, host_spans: Sequence[tuple], anchor: float,
                 window_s: float) -> ProfileRecord:
    """Reduce a finished profiler to a ``ProfileRecord``.  The window is
    the ``WINDOW_SPAN`` range, opened at host time ``anchor``; host spans
    (name, start, end on the host clock) are placed on the trace's clock
    by that anchor.  ``window_s`` (host clock) stands in when the trace
    has no such range."""
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[float, float]] = []
    kernels: Dict[str, Tuple[float, int]] = {}
    w0 = w1 = None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False) and e.device_type == cuda:
            continue            # a span's mark on the device timeline
        if e.device_type == cuda:
            if t1 > t0:
                dev.append((t0, t1))
            s, c = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (s + (t1 - t0) * 1e-6, c + 1)
        elif e.name == WINDOW_SPAN:
            w0, w1 = t0, t1
    if w0 is None or not dev:
        return ProfileRecord(window_s, None, kernels, {})
    busy = _union([(max(s, w0), min(e, w1)) for s, e in dev
                   if e > w0 and s < w1])
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    off = w0 - anchor * 1e6
    spans = [(s * 1e6 + off, e * 1e6 + off, name)
             for name, s, e in host_spans]
    return ProfileRecord((w1 - w0) * 1e-6,
                         sum(e - s for s, e in busy) * 1e-6, kernels,
                         _label_gaps(gaps, spans))


def _label_gaps(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost span open at each gap's middle."""
    marks = []
    for i, (s, e, _) in enumerate(spans):
        marks.append((s, 1, i))
        marks.append((e, 0, i))
    marks.sort()
    active: Dict[int, float] = {}
    out: Dict[str, float] = {}
    mi = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while mi < len(marks) and marks[mi][0] <= mid:
            t, kind, i = marks[mi]
            if kind:
                active[i] = t
            else:
                active.pop(i, None)
            mi += 1
        label = (spans[max(active, key=active.get)][2] if active
                 else "host")
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-6
    return out

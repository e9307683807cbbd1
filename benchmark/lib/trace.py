"""The traced run's reading of ``torch.profiler``: device activity
intervals (kernels, copies, sets; a CUDA graph's kernels appear as its
replays run them), the benchmark's own host spans (``record_function``
ranges named ``bench.*``), and from them the device's busy time, each
kernel's device time and launches, the top device operations and the idle
gaps by what the host was doing.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Tuple

from .arith import gaps, union_length

WINDOW = "bench.window"
# activities on the device's timeline that are waits, not work
_WAITS = ("Context Sync", "Stream Sync", "Event Sync", "Stream Wait", "Device Sync")


def start():
    """A running profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


class Trace:
    """The events of a stopped profiler, read once. Times are seconds on
    the profiler's clock."""

    def __init__(self, prof):
        dev, spans = [], []
        for e in prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                # a host span's image on the device timeline is not work
                if d > 0 and not name.startswith(_WAITS) and not name.startswith("bench."):
                    dev.append((name, s * 1e-9, (s + d) * 1e-9))
            elif name.startswith("bench."):
                spans.append((name, s * 1e-9, (s + d) * 1e-9))
        self.device = dev
        self.spans = spans
        win = [(s, e) for n, s, e in spans if n == WINDOW]
        if win:
            self.lo, self.hi = win[0]
        elif dev:
            self.lo, self.hi = min(s for _, s, _ in dev), max(e for _, _, e in dev)
        else:
            self.lo = self.hi = 0.0

    def add_host_spans(self, name: str, spans, window_start_perf: float) -> None:
        """Host spans timed by the benchmark's own clock (``time.perf_counter``
        seconds, e.g. on threads the profiler does not follow), placed on
        the profiler's clock by the window's start."""
        offset = self.lo - window_start_perf
        self.spans.extend((f"bench.{name}", s + offset, e + offset) for s, e in spans)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_length(((s, e) for _, s, e in self.device), self.lo, self.hi)

    def kernel(self, *parts: str) -> Tuple[float, int]:
        """(device seconds, launches) of the activities in the window whose
        name contains any of ``parts``."""
        t, n = 0.0, 0
        for name, s, e in self.device:
            if any(p in name for p in parts) and s >= self.lo and e <= self.hi:
                t += e - s
                n += 1
        return t, n

    def top_ops(self, k: int = 10) -> List[List]:
        """The k device activities that took most time in the window, by name."""
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            if s >= self.lo and e <= self.hi:
                tot[_short(name)] += e - s
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the device in the window, summed by the innermost
        (latest-started) ``bench.*`` span the host was in at each gap's
        middle; the k largest. One sweep over gaps and spans in time order."""
        tot: Dict[str, float] = defaultdict(float)
        spans = sorted((sp for sp in self.spans if sp[0] != WINDOW), key=lambda sp: sp[1])
        gs = gaps(((s, e) for _, s, e in self.device), self.lo, self.hi)
        active: List[Tuple[float, float, str]] = []   # heap of (-start, end, name)
        i = 0
        for g0, g1 in sorted(gs, key=lambda g: g[0] + g[1]):
            mid = (g0 + g1) / 2
            while i < len(spans) and spans[i][1] <= mid:
                heapq.heappush(active, (-spans[i][1], spans[i][2], spans[i][0]))
                i += 1
            # the latest-started span still open at mid; spans that ended are
            # dropped, and a later-started one covers what they would have
            while active and active[0][1] < mid:
                heapq.heappop(active)
            label = "host: " + active[0][2] if active else "host: in no benchmark span"
            tot[label] += g1 - g0
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _short(name: str, width: int = 120) -> str:
    """A kernel name cut to ``width``."""
    return name[:width]


def record(name: str):
    """A host span the trace reads (``bench.<name>``)."""
    from torch.profiler import record_function

    return record_function(f"bench.{name}")

"""The port's own tracing: host spans, a counter of each span's name, and
a timeline of spans on the profiler's clock while a profiler runs.

``with span(name, rid=None) as sp:`` stamps ``perf_counter_ns`` at entry
and exit; its parent is the span enclosing it on the same thread, and the
spans of one request share ``rid``. Every span adds its count and
nanoseconds to its name's counter (``totals()``): two clock reads and a dict
update under a lock. ``sp.seconds`` is its duration (so far, while open).
``add(name, start_ns, end_ns, rid)`` adds a span whose ends were read
elsewhere, such as a request's wait in a queue between two threads.

While a ``torch.profiler`` runs (``torch.autograd.profiler.
_is_profiler_enabled``), each span also goes into a bounded in-memory
timeline (``timeline()``, the last ``TIMELINE_MAX``) as a ``Record`` whose
times are nanoseconds on the profiler's clock: Unix-epoch nanoseconds, the
``perf_counter_ns`` reads moved by one offset, taken anew when it is a
second old so that the two clocks cannot drift apart. A reader takes the
spans of its own session by time (``timeline(since_ns)``). Spans never go
through ``record_function``: they leave no image on the device's
timeline, where an annotation would read as work. ``add_to_chrome_trace``
writes the timeline into a profiler's Chrome trace on the trace's own time
axis.

The counters and the timeline belong to the process, as the profiler's
own events do: every thread's spans land in them.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from collections import deque
from time import perf_counter_ns, time_ns
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

TIMELINE_MAX = 1 << 16
OFFSET_AGE_NS = 1_000_000_000  # the clock offset is taken anew after this


class Record(NamedTuple):
    """A span on the timeline; times in ns on the profiler's clock."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    rid: Optional[int]
    thread: int


class Total(NamedTuple):
    count: int
    seconds: float


_lock = threading.Lock()
_totals: Dict[str, List[int]] = {}   # name -> [count, ns]
_timeline: deque = deque(maxlen=TIMELINE_MAX)
_local = threading.local()
_ids = itertools.count(1)
_offset = {"ns": 0, "taken_ns": None}


def _clock_offset_ns() -> int:
    """``time_ns() - perf_counter_ns()``: the epoch read between two
    ``perf_counter_ns`` reads, the closest pair of five."""
    best = None
    for _ in range(5):
        a = perf_counter_ns()
        w = time_ns()
        b = perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def _offset_ns(now_ns: int) -> int:
    """The clock offset, taken anew when it is older than ``OFFSET_AGE_NS``."""
    taken = _offset["taken_ns"]
    if taken is None or now_ns - taken > OFFSET_AGE_NS:
        with _lock:
            _offset["ns"], _offset["taken_ns"] = _clock_offset_ns(), perf_counter_ns()
    return _offset["ns"]


def _thread():
    """This thread's stack of open spans and its native id."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.tid = threading.get_native_id()
    return stack


def _close(name: str, start_ns: int, end_ns: int, sid: int, parent: Optional[int],
           rid: Optional[int]) -> None:
    recording = getattr(_profiler, "_is_profiler_enabled", False)
    off = _offset_ns(end_ns) if recording else 0
    with _lock:
        c = _totals.get(name)
        if c is None:
            c = _totals[name] = [0, 0]
        c[0] += 1
        c[1] += end_ns - start_ns
        if recording:
            _timeline.append(Record(name, start_ns + off, end_ns + off, sid, parent, rid,
                                    _local.tid))


class span:
    """A host span; see the module docstring."""

    __slots__ = ("name", "rid", "id", "parent", "start_ns", "end_ns")

    def __init__(self, name: str, rid: Optional[int] = None):
        self.name, self.rid = name, rid
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "span":
        stack = _thread()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        _local.stack.pop()
        _close(self.name, self.start_ns, self.end_ns, self.id, self.parent, self.rid)
        return False

    @property
    def seconds(self) -> float:
        end = perf_counter_ns() if self.end_ns is None else self.end_ns
        return (end - self.start_ns) * 1e-9


def add(name: str, start_ns: int, end_ns: int, rid: Optional[int] = None) -> None:
    """A span of ``perf_counter_ns`` reads taken elsewhere, with no parent."""
    _thread()
    _close(name, start_ns, end_ns, next(_ids), None, rid)


def totals() -> Dict[str, Total]:
    """Each span name's count and seconds since the process started."""
    with _lock:
        return {n: Total(c, ns * 1e-9) for n, (c, ns) in _totals.items()}


def timeline(since_ns: int = 0) -> List[Record]:
    """The spans on the timeline that started at or after ``since_ns`` (ns
    on the profiler's clock: ``time.time_ns()`` before a session starts
    selects its spans), oldest first."""
    with _lock:
        return [r for r in _timeline if r.start_ns >= since_ns]


def add_to_chrome_trace(path, since_ns: int = 0) -> int:
    """Add ``timeline(since_ns)`` to the Chrome trace at ``path`` (written
    by a profiler's ``export_chrome_trace``), on its time axis (microseconds
    from its ``baseTimeNanoseconds``), as complete events of category
    ``dyd_span`` on this process and each span's thread -> spans added."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    records = timeline(since_ns)
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "dyd_span", "name": r.name, "pid": pid, "tid": r.thread,
         "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"id": r.id, "parent": r.parent, "rid": r.rid}} for r in records)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(records)

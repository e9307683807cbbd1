"""The traced run's reading of the program's own tracing: the train step's
phase stamps on the device's timeline (``dyd_stamp_<slot>_<phase>``
kernels, ``deal_yolo_daya_tpu_torch/ops/kernels/phase_stamp.py``), and the
program's host spans and counters (``deal_yolo_daya_tpu_torch.tracing``:
its timeline holds the spans of the profiler's session, on the profiler's
clock). A program without them reads None everywhere: no reading raises.

A step's phase k runs from stamp k's end to stamp k+1's start; between two
steps lies the time from a step's last stamp to the next step's first (the
host's staging copies and draws, and launch gaps).

The window's stamps are checked against its steps (``window_steps``);
where they differ (the profiler drops activities at times), one line on
standard error says what the trace held. A whole step or a pair of steps
read across lost stamps needs six or more of them lost in a row, and would
count more than one step's time: where six or more are missing, the steps
and pairs that span more than a step are left out.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from statistics import mean, median
from typing import Dict, List, Optional, Tuple

from .arith import gaps

STAMP = re.compile(r"dyd_stamp_(\d)_")
PHASES = ("augment", "forward", "loss", "backward", "optimizer")
SLOTS = len(PHASES) + 1
OUTSIDE = "no program span"


def stamps(tr) -> List[Tuple[int, float, float]]:
    """The stamp kernels in the window: (slot, start, end) in time order."""
    out = []
    for name, s, e in tr.device:
        m = STAMP.search(name)
        if m and s >= tr.lo and e <= tr.hi:
            out.append((int(m.group(1)), s, e))
    return sorted(out, key=lambda x: x[1])


def steps(tr) -> List[List[Tuple[float, float]]]:
    """The window's whole steps: six consecutive stamps of slots 0..5, each
    as (start, end)."""
    st, out, i = stamps(tr), [], 0
    while i + SLOTS <= len(st):
        if all(st[i + j][0] == j for j in range(SLOTS)):
            out.append([(s, e) for _, s, e in st[i:i + SLOTS]])
            i += SLOTS
        else:
            i += 1
    return out


def _pairs(tr) -> List[Tuple[float, float]]:
    """(a step's last stamp's end, the next step's first stamp's start) of
    each such pair of consecutive stamps in the window."""
    st = stamps(tr)
    return [(a[2], b[1]) for a, b in zip(st, st[1:]) if a[0] == SLOTS - 1 and b[0] == 0]


def audited(ctx) -> Tuple[List[List[Tuple[float, float]]], List[Tuple[float, float]]]:
    """The window's whole steps and pairs of steps, as ``steps`` and
    ``_pairs`` give them; where six or more stamps are missing, without
    those that span more than a step (see the module docstring). Read once
    a trace."""
    tr = ctx.tr
    done = getattr(tr, "_dyd_phases", None)
    if done is not None:
        return done
    whole, pairs = steps(tr), _pairs(tr)
    want = getattr(ctx, "counters", {}).get("window_steps")
    counts = [0] * SLOTS
    for slot, _, _ in stamps(tr):
        counts[slot] += 1
    if whole and (counts != [want] * SLOTS or len(whole) != want):
        missing = SLOTS * want - sum(counts) if want is not None else SLOTS
        if missing >= SLOTS:
            span = median(st[-1][0] - st[0][1] for st in whole)
            whole = [st for st in whole if st[-1][0] - st[0][1] <= 1.5 * span]
            pairs = [(a, b) for a, b in pairs if b - a <= span]
        print(f"phases: the trace holds stamps {counts} by slot for the window's {want} steps; "
              f"read over {len(whole)} whole steps and {len(pairs)} pairs"
              + (", those within a step" if missing >= SLOTS else ""), file=sys.stderr)
    tr._dyd_phases = whole, pairs
    return whole, pairs


def step_phases(ctx) -> List[Dict[str, float]]:
    """Each whole step's phases in milliseconds."""
    return [{p: (st[k + 1][0] - st[k][1]) * 1e3 for k, p in enumerate(PHASES)}
            for st in audited(ctx)[0]]


def phase_ms(ctx, phase: str) -> Optional[float]:
    """The mean of ``phase`` over the window's whole steps."""
    if ctx.tr is None:
        return None
    rows = step_phases(ctx)
    return mean(r[phase] for r in rows) if rows else None


def between_steps_ms(ctx) -> Optional[float]:
    """The mean time from a step's last stamp's end to the next step's
    first stamp's start, over such pairs in the window."""
    if ctx.tr is None:
        return None
    d = [(b - a) * 1e3 for a, b in audited(ctx)[1]]
    return mean(d) if d else None


def _tracing():
    try:
        from deal_yolo_daya_tpu_torch import tracing
    except ImportError:  # a program without its own tracing
        return None
    return tracing


def program_spans(tr, name: Optional[str] = None) -> Optional[List]:
    """The program's spans (``tracing.Record``) named ``name`` (all, for
    None) inside the window, or None without the program's timeline."""
    t = _tracing()
    if t is None or tr is None:
        return None
    return [r for r in t.timeline() if (name is None or r.name == name)
            and r.start_ns * 1e-9 >= tr.lo and r.end_ns * 1e-9 <= tr.hi]


def mean_span_ms(tr, name: str) -> Optional[float]:
    """The mean duration of the program's ``name`` spans in the window."""
    spans = program_spans(tr, name)
    return mean((r.end_ns - r.start_ns) * 1e-6 for r in spans) if spans else None


def counter_s(*names: str) -> Optional[float]:
    """The seconds the program's counters hold for ``names`` together, or
    None where none of them was recorded."""
    t = _tracing()
    if t is None:
        return None
    totals = t.totals()
    found = [totals[n].seconds for n in names if n in totals]
    return sum(found) if found else None


def _self_time(spans) -> Dict[str, List[Tuple[float, float]]]:
    """Each span name's own stretches: its spans less their children's
    intervals, in seconds, sorted."""
    children = defaultdict(list)
    for r in spans:
        if r.parent is not None:
            children[r.parent].append((r.start_ns, r.end_ns))
    out = defaultdict(list)
    for r in spans:
        t = r.start_ns
        for s, e in sorted(children.get(r.id, ())):
            if s > t:
                out[r.name].append((t * 1e-9, s * 1e-9))
            t = max(t, e)
        if r.end_ns > t:
            out[r.name].append((t * 1e-9, r.end_ns * 1e-9))
    return {n: _merged(v) for n, v in out.items()}


def _merged(intervals) -> List[Tuple[float, float]]:
    """Sorted intervals with the overlapping ones joined."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_program_span(tr) -> Optional[Dict[str, float]]:
    """The device's idle seconds in the window by the innermost program span
    open on the host (a span's own stretches, less its children's), and
    the rest under ``OUTSIDE``; None without the program's timeline. Where
    spans of several threads overlap, each name counts the idle time once
    and several names may count the same idle time."""
    spans = program_spans(tr)
    if spans is None or tr.window_s <= 0:
        return None
    idle = gaps(((s, e) for _, s, e in tr.device), tr.lo, tr.hi)
    out = {n: _overlap(idle, own) for n, own in _self_time(spans).items()}
    out[OUTSIDE] = max(0.0, sum(e - s for s, e in idle) - sum(out.values()))
    return out


def idle_in_span_pct(tr, name: str) -> Optional[float]:
    """The share of the window (%) in which the card was idle while the
    innermost program span was ``name``; None where it never ran there."""
    split = idle_by_program_span(tr)
    if split is None or name not in split:
        return None
    return 100.0 * split[name] / tr.window_s

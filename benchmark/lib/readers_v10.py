"""What the YOLOv10 cell's per-layer readers (``metrics/*.train_v10.py``)
share: the (36, 72) attention builds' rooflines and the loss mark's
phase. A program without the kernels or the mark reads None."""

from __future__ import annotations

from statistics import mean

from . import arith, phases
from .costs_v10 import v10_costs

MARK = "dyd_mark_loss_o2o"


def k36_roofline(ctx, backward: bool, *kernels: str):
    """The named kernels' share of their roofline over the traced window:
    the bound of one launch of the cell's attention calls at (36, 72) times
    the launches the profiler saw (a backward is one launch of each of its
    kernels), over their device time."""
    if ctx.tr is None:
        return None
    calls = [c for c in v10_costs(ctx.cfg, ctx.wl["imgsz"])["attention_calls"]
             if c[3:] == (36, 72)]
    bound, launches = arith.attention_step_cost(calls, ctx.wl["batch"], backward)
    t, n = ctx.tr.kernel(*kernels)
    if not n or not launches:
        return None
    return arith.roofline_pct(bound / launches * n / len(kernels), t)


def loss_o2o_ms(ctx):
    """The mean milliseconds from the loss mark's end to stamp 3's start over
    the window's whole steps with a mark inside their loss phase."""
    if ctx.tr is None:
        return None
    marks = sorted(e for name, s, e in ctx.tr.device if MARK in name
                   and s >= ctx.tr.lo and e <= ctx.tr.hi)
    if not marks:
        return None
    out = []
    for st in phases.audited(ctx)[0]:
        lo, hi = st[2][1], st[3][0]  # stamp 2's end, stamp 3's start
        inside = [e for e in marks if lo <= e <= hi]
        if inside:
            out.append((hi - inside[-1]) * 1e3)
    return mean(out) if out else None

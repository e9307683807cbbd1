"""What the per-layer metric readers (``benchmark/metrics/``) share."""

from __future__ import annotations

from benchmark.lib import arith


def idle_pct(ctx):
    if ctx.tr is None or ctx.tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.tr.busy_s / ctx.tr.window_s)


def forward_flops(ctx) -> float:
    """The configuration's forward FLOPs of one image at the cell's size."""
    return arith.model_costs(ctx.cfg, ctx.wl["imgsz"])["forward_flops"]


def attention_roofline(ctx, backward: bool, *kernels: str):
    """The attention kernels' share of their roofline over the traced
    window: the bound of one launch (averaged over the step's calls) times
    the launches the profiler saw, over their device time."""
    if ctx.tr is None:
        return None
    calls = arith.model_costs(ctx.cfg, ctx.wl["imgsz"])["attention_calls"]
    bound, launches = arith.attention_step_cost(calls, ctx.wl["batch"], backward)
    t, n = ctx.tr.kernel(*kernels)
    if not n or not launches:
        return None
    if backward and len(kernels) > 1:  # each backward is one launch of each kernel
        n = n / len(kernels)
    return arith.roofline_pct(bound / launches * n, t)


def nms_roofline(ctx, rows: float):
    """NMS's share of its roofline over the traced window: every row of the
    launches (``rows`` in all) with its 1000 candidates valid."""
    if ctx.tr is None or rows <= 0:
        return None
    t, n = ctx.tr.kernel("nms_kernel")
    if not n:
        return None
    flops, nbytes = arith.nms_cost(int(rows), 1000)
    return arith.roofline_pct(arith.bound_s(flops, nbytes, arith.PEAKS["f32_flops"]), t)

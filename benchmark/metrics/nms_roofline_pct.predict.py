"""nms_roofline_pct.predict: the NMS suppression kernel's share of its
roofline in the traced predict window: every row of every batch with 1000
valid candidates."""

from benchmark.lib.readers import nms_roofline


def read(ctx):
    return nms_roofline(ctx, ctx.counters.get("nms_rows", 0))

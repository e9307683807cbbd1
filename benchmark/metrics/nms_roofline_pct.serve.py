"""nms_roofline_pct.serve: the NMS suppression kernel's share of its
roofline in the traced serving window: every slot of every device batch
(served and padded) with 1000 valid candidates."""

from benchmark.lib.readers import nms_roofline


def read(ctx):
    c = ctx.counters
    return nms_roofline(ctx, c.get("served", 0) + c.get("padded", 0))

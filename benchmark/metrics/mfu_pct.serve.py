"""mfu_pct.serve: forward FLOPs of the images served in the traced window
(padding not counted) over its length and the bf16 peak."""

from benchmark.lib import arith
from benchmark.lib.readers import forward_flops


def read(ctx):
    if ctx.tr is None:
        return None
    return arith.mfu_pct(forward_flops(ctx), ctx.counters["served"], ctx.tr.window_s)

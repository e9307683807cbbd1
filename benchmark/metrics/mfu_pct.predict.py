"""mfu_pct.predict: forward FLOPs of the images predict returned in the
traced window over its length and the bf16 peak."""

from benchmark.lib import arith
from benchmark.lib.readers import forward_flops


def read(ctx):
    if ctx.tr is None:
        return None
    return arith.mfu_pct(forward_flops(ctx), ctx.counters["window_images"], ctx.tr.window_s)

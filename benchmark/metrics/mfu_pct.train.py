"""mfu_pct.train: the whole training step's share of the bf16 peak: 3 x the
forward FLOPs of an image (no recomputation) times the traced window's
images, over its length and 989 TFLOP/s."""

from benchmark.lib import arith
from benchmark.lib.readers import forward_flops


def read(ctx):
    if ctx.tr is None:
        return None
    return arith.mfu_pct(arith.TRAIN_FLOPS_PER_FORWARD * forward_flops(ctx),
                         ctx.counters["window_images"], ctx.tr.window_s)

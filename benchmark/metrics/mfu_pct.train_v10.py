"""mfu_pct.train_v10: a YOLOv10 training step's share of the bf16 peak: 3 x
the training forward's FLOPs of an image (both heads, ``lib/costs_v10.py``;
no recomputation) times the traced window's images, over its length and
989 TFLOP/s."""

from benchmark.lib import arith
from benchmark.lib.costs_v10 import v10_costs


def read(ctx):
    if ctx.tr is None:
        return None
    flops = v10_costs(ctx.cfg, ctx.wl["imgsz"])["forward_flops"]
    return arith.mfu_pct(arith.TRAIN_FLOPS_PER_FORWARD * flops, ctx.counters["window_images"],
                         ctx.tr.window_s)

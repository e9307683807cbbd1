"""loss_o2o_ms.train_v10: device milliseconds of a YOLOv10 step's one-to-one
loss: from the end of the loss mark ``dyd_mark_loss_o2o`` (between the two
heads' assignments) to the start of stamp 3, the mean over the traced
window's whole steps that hold a mark; None without the mark."""

from benchmark.lib.readers_v10 import loss_o2o_ms


def read(ctx):
    return loss_o2o_ms(ctx)

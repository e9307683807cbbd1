"""loss_ms.train: device milliseconds of the train step's loss phase, the
detection loss (decode, TAL assigner, CIoU, DFL, BCE): stamp 2's end to
stamp 3's start; the mean over the traced window's whole steps, read from
the phase stamps' kernels on the device's timeline."""

from benchmark.lib import phases


def read(ctx):
    return phases.phase_ms(ctx, "loss")

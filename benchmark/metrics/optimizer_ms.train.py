"""optimizer_ms.train: device milliseconds of the train step's optimizer
phase, the gradient all-reduce under data parallelism, the optimizer, the
EMA and the loss sums: stamp 4's end to stamp 5's start; the mean over the
traced window's whole steps, read from the phase stamps' kernels on the
device's timeline."""

from benchmark.lib import phases


def read(ctx):
    return phases.phase_ms(ctx, "optimizer")

"""backward_ms.train: device milliseconds of the train step's backward phase,
the backward: stamp 3's end to stamp 4's start; the mean over the traced
window's whole steps, read from the phase stamps' kernels on the device's
timeline."""

from benchmark.lib import phases


def read(ctx):
    return phases.phase_ms(ctx, "backward")

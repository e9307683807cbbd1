"""forward_ms.train: device milliseconds of the train step's forward phase,
the gradient-keep multiply and the model's forward under autocast: stamp
1's end to stamp 2's start; the mean over the traced window's whole steps,
read from the phase stamps' kernels on the device's timeline."""

from benchmark.lib import phases


def read(ctx):
    return phases.phase_ms(ctx, "forward")

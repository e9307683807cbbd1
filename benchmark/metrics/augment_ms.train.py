"""augment_ms.train: device milliseconds of the train step's augment phase,
the gather from the device cache and the on-card augmentation
(``device_augment.apply``): stamp 0's end to stamp 1's start; the mean
over the traced window's whole steps, read from the phase stamps' kernels
on the device's timeline."""

from benchmark.lib import phases


def read(ctx):
    return phases.phase_ms(ctx, "augment")

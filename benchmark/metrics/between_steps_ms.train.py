"""between_steps_ms.train: device milliseconds from a step's last phase
stamp to the next step's first, the mean over the traced window: the
device's time outside the step graph (the staging's copies and draws, and
the gaps while the host stages and launches)."""

from benchmark.lib import phases


def read(ctx):
    return phases.between_steps_ms(ctx)

"""warmup_s.train: host seconds of the step program's eager warm-up steps
and graph captures in set-up, from the program's counters of the
``train.warmup`` and ``train.capture`` spans."""

from benchmark.lib import phases


def read(ctx):
    return phases.counter_s("train.warmup", "train.capture") if ctx.tr is not None else None

"""letterbox_ms.predict: host milliseconds of ``predict``'s preparation of
a batch (decode where a source is a file, letterbox, into the pinned
batch), the mean ``predict.prepare`` span of the program's timeline in the
traced window."""

from benchmark.lib import phases


def read(ctx):
    return phases.mean_span_ms(ctx.tr, "predict.prepare")

"""queue_wait_ms.serve: milliseconds a request waits in the Engine's queue,
from its submit to its dequeue by the dispatcher, the mean
``serve.queue_wait`` span of the program's timeline in the traced window."""

from benchmark.lib import phases


def read(ctx):
    return phases.mean_span_ms(ctx.tr, "serve.queue_wait")

"""avg_batch.serve: requests a device batch, from ``Engine.stats()`` before
and after the traced window."""


def read(ctx):
    b = ctx.counters.get("batches")
    if ctx.tr is None or not b:
        return None
    return ctx.counters["served"] / b

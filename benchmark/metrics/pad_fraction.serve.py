"""pad_fraction.serve: padded slots over all slots of the traced window's
device batches, from ``Engine.stats()`` before and after it."""


def read(ctx):
    c = ctx.counters
    slots = c.get("served", 0) + c.get("padded", 0)
    if ctx.tr is None or not slots:
        return None
    return 100.0 * c["padded"] / slots

"""submit_ms.serve: host time of ``Engine.submit`` (the letterbox on the
caller's thread), the mean over the traced window's requests."""


def read(ctx):
    return ctx.counters.get("submit_ms_mean") if ctx.tr is not None else None

"""device_idle_pct.train: share of the traced training window in which no
kernel or copy ran on the card."""

from benchmark.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)

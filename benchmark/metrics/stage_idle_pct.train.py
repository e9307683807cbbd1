"""stage_idle_pct.train: share of the traced window in which the card was
idle while the host's innermost program span was ``train.stage``."""

from benchmark.lib import phases


def read(ctx):
    return phases.idle_in_span_pct(ctx.tr, "train.stage")

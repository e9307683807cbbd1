"""bn_ms.train: device milliseconds a train step of the train-mode
BatchNorm's kernels, those whose names hold ``batch_norm`` (PyTorch's own
channels-last batch-norm kernels) or ``dyd_bn_`` (the port's
``csrc/batch_norm_act.cu``), summed over the traced window's whole steps
(``lib/phases.py::audited``) and divided by their number; None without
whole steps.

What the reading holds depends on the program: PyTorch's four kernels
leave out the SiLU after each BatchNorm and the running statistics' small
launches, which run as other kernels; the port's fused kernels hold the
SiLU, forward and backward, and the running update."""

import bisect
import copy

from benchmark.lib import phases

KERNELS = ("batch_norm", "dyd_bn_")


def read(ctx):
    if ctx.tr is None:
        return None
    whole = phases.audited(ctx)[0]
    if not whole:
        return None
    found = sorted((s, e, name) for name, s, e in ctx.tr.device
                   if any(p in name for p in KERNELS))
    starts = [s for s, _, _ in found]
    step = copy.copy(ctx.tr)  # the trace seen one whole step at a time
    total = 0.0
    for st in whole:
        step.lo, step.hi = st[0][0], st[-1][1]
        i, j = bisect.bisect_left(starts, step.lo), bisect.bisect_right(starts, step.hi)
        step.device = [(name, s, e) for s, e, name in found[i:j]]
        total += step.kernel(*KERNELS)[0]
    return total / len(whole) * 1e3

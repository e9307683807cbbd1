"""bn_ms.train on hand-made profiler events: the batch-norm kernels' device
time a whole step, PyTorch's kernels (the parent program) and the port's
fused ones alike, and nothing outside the window's whole steps."""

import types

import pytest

from benchmark.lib import trace as T
from benchmark.tests.test_bench_phases import _reader, _step
from benchmark.tests.test_bench_trace import Ev, Prof

ATEN = ("void at::native::batch_norm_collect_statistics_channels_last_kernel<float>(x)",
        "void at::native::batch_norm_transform_input_channels_last_kernel<float>(x)",
        "void at::native::batch_norm_backward_reduce_channels_last_kernel<float>(x)",
        "void at::native::batch_norm_backward_elemt_channels_last_kernel<float>(x)")
FUSED = ("void dyd_bn_stats<__nv_bfloat16, 8, 4>(x)", "void dyd_bn_apply<__nv_bfloat16, 8, 4, true>(x)",
         "void dyd_bn_bwd_reduce<__nv_bfloat16, 8, 4, true>(x)",
         "void dyd_bn_bwd_elemt<__nv_bfloat16, 8, 4, true>(x)")


def _window(names, lengths):
    """A window [1, 2] s of three whole steps from 1.0, 1.3 and 1.6 s; in
    each step's forward and backward phases the kernels ``names`` of
    ``lengths`` seconds, and one of each before the window and after the
    last step's end."""
    ev = [Ev("bench.window", False, 1.0, 2.0)]
    for t0 in (1.0, 1.3, 1.6):
        step, _ = _step(t0, (0.01, 0.08, 0.02, 0.12, 0.01))
        ev += step
        fwd, bwd = t0 + 0.012 + 0.001, t0 + 0.012 + 0.081 + 0.021 + 0.001
        for k, (name, dt) in enumerate(zip(names, lengths)):
            at = fwd if k < 2 else bwd
            ev.append(Ev(name, True, at + 0.01 * (k % 2), at + 0.01 * (k % 2) + dt))
    for name in names:
        ev.append(Ev(name, True, 0.5, 0.6))    # before the window
        ev.append(Ev(name, True, 1.95, 1.96))  # after the last whole step
    return types.SimpleNamespace(tr=T.Trace(Prof(ev)), counters={"window_steps": 3})


@pytest.mark.parametrize("names", [ATEN, FUSED], ids=["pytorch_kernels", "fused_kernels"])
def test_batch_norm_ms_a_whole_step(names, capsys):
    ctx = _window(names, (0.002, 0.003, 0.004, 0.005))
    assert _reader("bn_ms.train").read(ctx) == pytest.approx(14.0)
    assert capsys.readouterr().err == ""


def test_other_kernels_and_programs_without_stamps_read_nothing_or_none():
    ctx = _window(("void at::native::silu_kernel(x)", "conv", "gemm", "copy"),
                  (0.002, 0.003, 0.004, 0.005))
    assert _reader("bn_ms.train").read(ctx) == 0.0
    tr = T.Trace(Prof([Ev("bench.window", False, 1.0, 2.0), Ev(FUSED[0], True, 1.1, 1.2)]))
    assert _reader("bn_ms.train").read(types.SimpleNamespace(tr=tr, counters={})) is None
    assert _reader("bn_ms.train").read(types.SimpleNamespace(tr=None)) is None

"""The readers of the program's own tracing (``lib/phases.py`` and the
metrics that use it) on hand-made profiler events and a stand-in program
timeline; on the card, the tracing itself against the profiler."""

import statistics
import time
import types

import pytest

from benchmark import run as R
from benchmark.lib import phases as P, trace as T
from benchmark.tests.test_bench_trace import Ev, Prof

STAMPS = tuple(f"dyd_stamp_{i}_{p}(unsigned long long*, int)" for i, p in
               enumerate(("augment", "forward", "loss", "backward", "optimizer", "end")))
NEW = ("augment_ms.train", "forward_ms.train", "loss_ms.train", "backward_ms.train",
       "optimizer_ms.train", "between_steps_ms.train", "stage_ms.train", "stage_idle_pct.train",
       "warmup_s.train")
DEVICE_SIX = NEW[:6]


def _step(t0, lengths, stamp=0.001):
    """Six stamps from t0 with the phases' lengths between them, a kernel
    filling each phase -> (events, end of the last stamp)."""
    ev, t = [], t0
    for k, name in enumerate(STAMPS):
        ev.append(Ev(name, True, t, t + stamp))
        t += stamp
        if k < len(lengths):
            ev.append(Ev(f"kernel_{k}", True, t, t + lengths[k]))
            t += lengths[k]
    return ev, t


def _trace():
    """A window [1, 2] s: three whole steps from 1.0, 1.25 and 1.6 s, and a
    copy between the first two -> (trace, each step's end)."""
    ev, ends = [Ev("bench.window", False, 1.0, 2.0)], []
    for t0, lengths in ((1.0, (0.05, 0.03, 0.02, 0.06, 0.01)),
                        (1.25, (0.04, 0.03, 0.02, 0.06, 0.02)),
                        (1.6, (0.05, 0.03, 0.02, 0.06, 0.03))):
        step, end = _step(t0, lengths)
        ev += step
        ends.append(end)
    ev.append(Ev("Memcpy HtoD", True, ends[0] + 0.01, ends[0] + 0.02))
    return T.Trace(Prof(ev)), ends


def _reader(name):
    return R.load_module(R.HERE / "metrics" / f"{name}.py", f"m_{name.replace('.', '_')}")


def test_phases_from_the_stamps(capsys):
    tr, ends = _trace()
    ctx = types.SimpleNamespace(tr=tr, counters={"window_steps": 3})
    assert len(P.steps(tr)) == 3
    assert P.phase_ms(ctx, "augment") == pytest.approx(140.0 / 3)
    assert P.phase_ms(ctx, "optimizer") == pytest.approx(20.0)
    assert P.phase_ms(ctx, "loss") == pytest.approx(20.0)
    # a step's end to the next's start: [ends[0], 1.25] and [ends[1], 1.6]
    assert P.between_steps_ms(ctx) == pytest.approx(((1.25 - ends[0]) + (1.6 - ends[1])) / 2 * 1e3)
    six = [_reader(n).read(ctx) for n in DEVICE_SIX]
    # each phase from a stamp's end to the next one's start: the kernels
    assert sum(six[:5]) == pytest.approx((0.17 + 0.17 + 0.19) / 3 * 1e3)
    assert six[5] == P.between_steps_ms(ctx)
    assert capsys.readouterr().err == ""  # the stamps match the window's steps


@pytest.mark.parametrize("lost", [range(12, 18), range(11, 17), range(17, 18)],
                         ids=["a_whole_step", "across_two_steps", "one_stamp"])
def test_stamps_lost_in_the_trace_are_read_around(lost, capsys):
    """Five steps 0.1 s apart, each 94 ms from its first stamp's end to its
    last's start and 4 ms between steps; the trace lost six stamps in a
    row: all of step 2's (a pair of steps 1 and 3 would span 104 ms), or
    step 1's last and step 2's first five (a "whole step" of 194 ms); or
    step 2's last stamp alone, which joins no two steps."""
    ev = [Ev("bench.window", False, 1.0, 2.0)]
    for i in range(5):
        ev += _step(1.0 + 0.1 * i, (0.02, 0.02, 0.02, 0.02, 0.01))[0]
    st = [e for e in ev if P.STAMP.search(e.name())]
    ev = [e for e in ev if e not in [st[j] for j in lost]]
    ctx = types.SimpleNamespace(tr=T.Trace(Prof(ev)), counters={"window_steps": 5})
    for phase, want in zip(P.PHASES, (20.0, 20.0, 20.0, 20.0, 10.0)):
        assert P.phase_ms(ctx, phase) == pytest.approx(want)
    assert P.between_steps_ms(ctx) == pytest.approx(4.0)
    err = capsys.readouterr().err
    assert err.count("phases: the trace holds stamps") == 1  # once a trace
    if len(lost) == 6:
        assert "[4, 4, 4, 4, 4, 4] by slot" in err and "those within a step" in err
    else:
        assert "[5, 5, 5, 5, 5, 4] by slot" in err and "within" not in err


def _records(tracing):
    R_ = tracing.Record
    s = lambda t: int(t * 1e9)  # noqa: E731
    return [R_("train.dispatch", s(1.0), s(1.5), 1, None, None, 9),
            R_("train.stage", s(1.0), s(1.1), 2, 1, None, 9),
            R_("train.replay", s(1.1), s(1.12), 3, 1, None, 9),
            R_("train.stage", s(1.3), s(1.34), 4, 1, None, 9),
            R_("train.replay", s(1.34), s(1.35), 5, 1, None, 9),
            R_("train.stage", s(2.5), s(2.6), 6, None, None, 9)]  # after the window


@pytest.fixture
def program(monkeypatch):
    from deal_yolo_daya_tpu_torch import tracing

    recs = _records(tracing)
    fake = types.SimpleNamespace(
        timeline=lambda since_ns=0: list(recs),
        totals=lambda: {"train.warmup": tracing.Total(3, 6.5),
                        "train.capture": tracing.Total(1, 1.25)})
    monkeypatch.setattr(P, "_tracing", lambda: fake)
    return recs


def test_program_spans_and_idle(program):
    # busy [1.0, 1.05] and [1.2, 1.32]: idle [1.05, 1.2], [1.32, 2.0]
    tr = T.Trace(Prof([Ev("bench.window", False, 1.0, 2.0), Ev("k", True, 1.0, 1.05),
                       Ev("k", True, 1.2, 1.32)]))
    ctx = types.SimpleNamespace(tr=tr)
    assert _reader("stage_ms.train").read(ctx) == pytest.approx(70.0)
    split = P.idle_by_program_span(tr)
    # stage's own stretches [1.0, 1.1] and [1.3, 1.34]: idle 0.05 + 0.02
    assert split["train.stage"] == pytest.approx(0.07)
    assert split["train.replay"] == pytest.approx(0.02 + 0.01)
    # dispatch's own: [1.12, 1.3], [1.35, 1.5]: idle 0.08 + 0.15
    assert split["train.dispatch"] == pytest.approx(0.23)
    assert split[P.OUTSIDE] == pytest.approx(0.5)
    assert sum(split.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert _reader("stage_idle_pct.train").read(ctx) == pytest.approx(7.0)
    assert _reader("warmup_s.train").read(ctx) == pytest.approx(7.75)


def test_a_program_without_its_tracing_reads_nothing(monkeypatch):
    """The parent program: no stamp kernels, no ``tracing`` module."""
    monkeypatch.setattr(P, "_tracing", lambda: None)
    tr = T.Trace(Prof([Ev("bench.window", False, 1.0, 2.0), Ev("k", True, 1.0, 1.5)]))
    for ctx in (types.SimpleNamespace(tr=tr), types.SimpleNamespace(tr=None)):
        for name in NEW:
            assert _reader(name).read(ctx) is None, name
    for name in ("queue_wait_ms.serve", "letterbox_ms.predict"):
        assert _reader(name).read(types.SimpleNamespace(tr=tr)) is None


def test_the_real_module_is_found():
    from deal_yolo_daya_tpu_torch import tracing

    assert P._tracing() is tracing


# ------------------------------------------------------------------- card


def _sleep_cycles(ms: float) -> int:
    """The ``torch.cuda._sleep`` cycles of about ``ms`` milliseconds."""
    import torch

    n = 10_000_000
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(n)
    b.record()
    b.synchronize()
    return int(n * ms / a.elapsed_time(b))


@pytest.mark.card
def test_a_span_contains_its_kernel_on_the_card(card):
    """A span around a ~5 ms sleep kernel and a synchronise holds that
    kernel's interval in the trace, within 50 us."""
    import torch

    from deal_yolo_daya_tpu_torch import tracing

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    cycles = _sleep_cycles(5.0)
    since = time.time_ns()
    prof = T.start()
    for _ in range(5):
        with tracing.span("t.sleep"):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    prof.stop()
    recs = [r for r in tracing.timeline(since) if r.name == "t.sleep"]
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA") and "spin" in e.name())
    assert len(recs) == len(kernels) == 5
    for r, (k0, k1) in zip(recs, kernels):
        assert k1 - k0 > 1_000_000  # a real sleep
        assert r.start_ns - 50_000 <= k0 and k1 <= r.end_ns + 50_000, (r, k0, k1)
        assert r.end_ns - k1 < 1_000_000  # the synchronise returns soon after


@pytest.mark.card
@pytest.mark.parametrize("name", ["yolo11n.train.b32", "yolo12n.train.b32"])
def test_phases_on_the_card(name, card, monkeypatch):
    """A traced run of the cell: the program's ring (``phase_ms``) agrees
    with the trace's phases within 5% or 20 us; the six device metrics sum
    to within 2% of the window's step period; no program-named activity on
    the device's timeline but the stamps; every new metric reads."""
    from deal_yolo_daya_tpu_torch.train import step_graph

    rings = []
    init = step_graph.StepProgram.__init__

    def keep_ring(self, *a, **k):
        init(self, *a, **k)
        rings.append(self.stamps)

    monkeypatch.setattr(step_graph.StepProgram, "__init__", keep_ring)
    ctx = R.execute(name, 2_760_000_017, 4.0, True)
    assert ctx.correct
    tr = ctx.tr
    values = {m: _reader(m).read(ctx) for m in NEW}
    assert all(v is not None for v in values.values()), values
    period_ms = tr.window_s / ctx.counters["window_steps"] * 1e3
    assert abs(sum(values[m] for m in DEVICE_SIX) - period_ms) <= 0.02 * period_ms, \
        (values, period_ms, ctx.counters["window_steps"], len(P.steps(tr)),
         [sum(1 for s, _, _ in P.stamps(tr) if s == k) for k in range(P.SLOTS)])
    ring = rings[-1].phase_ms()
    rows = P.step_phases(ctx)[-rings[-1].steps:]  # the ring's steps, if the window holds them
    for phase in P.PHASES:
        want = statistics.median(r[phase] for r in rows)
        assert abs(ring[phase] - want) <= max(0.05 * want, 0.02), (phase, ring[phase], want)
    spans = ("train.", "serve.", "predict.", "dyd.")
    named = {n for n, _, _ in tr.device if n.startswith(spans) or
             ("dyd" in n and not P.STAMP.search(n))}
    assert not named

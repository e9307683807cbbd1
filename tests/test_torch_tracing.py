"""The port's own tracing on the CPU: host spans, their counters and the
timeline on the profiler's clock (``tracing``), the train step's phase
stamps through the step program (a stand-in stamp observes them: the stamp
kernel runs on the card only), the step program's spans, the profiled
epoch's start, the Engine's and predict's spans and the bounded serving
statistics."""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from deal_yolo_daya_tpu_torch import tracing
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.ops.kernels import _build, phase_stamp
from deal_yolo_daya_tpu_torch.serve import WINDOW, Engine, ServeStats, serve_http
from deal_yolo_daya_tpu_torch.train import step_graph, trainer as trainer_mod
from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
from deal_yolo_daya_tpu_torch.train.step_graph import StepProgram
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, Trainer, TrainState
from tests.test_data import make_dataset
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

IMGSZ, BATCH, MAX_BOXES, NC = 64, 2, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Profiled:
    """A running CPU profiler; ``records`` are its session's spans."""

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.since = time.time_ns()
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        self.records = tracing.timeline(self.since)


def _mine(records, names):
    return [r for r in records if r.name in names]


# ------------------------------------------------------------------ spans


def test_no_timeline_without_a_profiler():
    before = tracing.totals().get("t.off", tracing.Total(0, 0.0))
    for _ in range(5):
        with tracing.span("t.off") as sp:
            time.sleep(0.001)
    after = tracing.totals()["t.off"]
    assert after.count == before.count + 5
    assert after.seconds - before.seconds >= 0.005
    assert sp.seconds >= 0.001
    assert not _mine(tracing.timeline(), {"t.off"})


def test_timeline_is_bounded_and_keeps_the_newest():
    with _Profiled() as p:
        for i in range(tracing.TIMELINE_MAX + 10):
            with tracing.span("t.bound", rid=i):
                pass
    rids = [r.rid for r in p.records if r.name == "t.bound"]
    assert len(p.records) == tracing.TIMELINE_MAX
    assert rids[0] == 10 and rids[-1] == tracing.TIMELINE_MAX + 9


def test_a_session_reads_its_own_spans():
    with _Profiled():
        with tracing.span("t.first"):
            pass
    with tracing.span("t.between"):  # no profiler: not on the timeline
        pass
    with _Profiled() as p:
        with tracing.span("t.second"):
            pass
    assert [r.name for r in p.records] == ["t.second"]
    assert [r.name for r in tracing.timeline()][-2:] == ["t.first", "t.second"]


def test_parents_and_request_ids():
    with _Profiled() as p:
        t0 = time.perf_counter_ns()
        with tracing.span("t.outer") as outer:
            with tracing.span("t.inner", rid=7) as inner:
                pass
            with tracing.span("t.inner", rid=8):
                pass

        def other():  # another thread: its own stack
            with tracing.span("t.thread", rid=9):
                pass

        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        t1 = time.perf_counter_ns()
        tracing.add("t.added", t0, t1, rid=7)
    recs = {(r.name, r.rid): r for r in p.records}
    assert recs[("t.outer", None)].parent is None
    assert recs[("t.inner", 7)].parent == outer.id == recs[("t.outer", None)].id
    assert recs[("t.inner", 8)].parent == outer.id
    assert recs[("t.inner", 7)].id == inner.id
    assert recs[("t.thread", 9)].parent is None
    assert recs[("t.thread", 9)].thread != recs[("t.outer", None)].thread
    added = recs[("t.added", 7)]
    assert added.parent is None and added.end_ns - added.start_ns == t1 - t0
    assert inner.start_ns >= outer.start_ns and inner.end_ns <= outer.end_ns


def test_timeline_is_on_the_profilers_clock():
    """Each span's timeline times fall inside the ``time.time_ns()`` reads
    around it, and a profiler event inside the span falls inside its
    timeline times."""
    n = 20
    brackets = []
    with _Profiled() as p:
        for i in range(n):
            a = time.time_ns()
            with tracing.span("t.clock", rid=i):
                with record_function("t.probe"):
                    pass
            brackets.append((a, time.time_ns()))
    spans = sorted(_mine(p.records, {"t.clock"}), key=lambda r: r.rid)
    events = sorted((e for e in p.prof.profiler.kineto_results.events()
                     if e.name() == "t.probe"), key=lambda e: e.start_ns())
    assert len(spans) == len(events) == n
    for (a, b), r, e in zip(brackets, spans, events):
        assert a <= r.start_ns <= r.end_ns <= b
        assert r.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= r.end_ns


def test_chrome_trace_gets_the_timeline_on_its_axis(tmp_path):
    with _Profiled() as p:
        with tracing.span("t.chrome"):
            with record_function("t.inside"):
                torch.ones(8).sum()
    path = tmp_path / "trace.json"
    p.prof.export_chrome_trace(str(path))
    assert tracing.add_to_chrome_trace(path, p.since) == len(p.records) == 1
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "dyd_span" and e["name"] == "t.chrome"]
    inside = [e for e in events if e.get("name") == "t.inside"]
    assert len(ours) == 1 and len(inside) == 1
    assert ours[0]["ts"] <= inside[0]["ts"]
    assert inside[0]["ts"] + inside[0]["dur"] <= ours[0]["ts"] + ours[0]["dur"]


# ------------------------------------------------------------- the stamps


def test_ring_reads_medians_of_its_last_steps():
    steps = 4
    ring = np.zeros(steps * 6 + 1, np.int64)
    base = 1_790_000_000_000_000_000  # epoch-sized timestamps keep their ns
    for step in range(6):  # steps 4 and 5 overwrite rows 0 and 1
        row = ring[(step % steps) * 6:(step % steps) * 6 + 6]
        row[:] = base + step * 10**8 + np.cumsum([0, 1, 2, 3, 4, 5]) * (step + 1) * 1000
    ring[-1] = 6
    got = phase_stamp.ring_phase_ms(ring, steps)
    # steps 2-5: phase k lasts (k + 1) * (step + 1) us
    for k, p in enumerate(phase_stamp.PHASES):
        assert got[p] == pytest.approx(np.median([(k + 1) * (s + 1) for s in (2, 3, 4, 5)]) / 1e3)
    assert phase_stamp.ring_phase_ms(np.zeros(steps * 6 + 1, np.int64), steps) is None
    assert phase_stamp.STAMPS[2] == "dyd_stamp_2_loss"


def test_ring_is_a_no_op_on_the_cpu():
    ring = phase_stamp.Ring(torch.device("cpu"))
    n = phase_stamp.launches
    ring(0)
    assert ring.buf is None and ring.phase_ms() is None and phase_stamp.launches == n
    assert "phase_stamp" in _build.EXTRA


def _cache(n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (n, IMGSZ, IMGSZ, 3), generator=g, dtype=torch.uint8)
    hw = torch.full((n, 2), float(IMGSZ))
    boxes = torch.zeros((n, MAX_BOXES, 4))
    boxes[:, :2] = torch.tensor([[8.0, 8.0, 40.0, 48.0], [20.0, 4.0, 60.0, 30.0]])
    classes = torch.zeros((n, MAX_BOXES), dtype=torch.int32)
    classes[:, 1] = 1
    mask = torch.zeros((n, MAX_BOXES), dtype=torch.bool)
    mask[:, :2] = True
    return images, hw, boxes, classes, mask


@pytest.fixture(scope="module")
def program():
    cfg = TrainConfig(model="yolo11n", imgsz=IMGSZ, batch=BATCH, amp=False, epochs=1,
                      warmup_epochs=0.0, max_boxes=MAX_BOXES, device="cpu")
    state = TrainState(cfg, NC, steps_per_epoch=3, device=torch.device("cpu"))
    return StepProgram(state, _cache(), DeviceAugConfig(), IMGSZ, MAX_BOXES, BATCH)


def test_six_stamps_fire_in_order_through_the_iteration(program, monkeypatch):
    seen = []
    stamps = program.stamps
    monkeypatch.setattr(program, "stamps", seen.append)

    def marked(mark, fn):
        def call(*a, **k):
            seen.append(mark)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(step_graph, "apply", marked("apply", step_graph.apply))
    monkeypatch.setattr(program.state, "forward", marked("forward", program.state.forward))
    monkeypatch.setattr(trainer_mod, "detection_loss",
                        marked("loss", trainer_mod.detection_loss))
    program.run(np.array([[0, 1], [2, 3]]), [11, 12])
    one = [0, "apply", 1, "forward", 2, "loss", 3, 4, 5]
    assert seen == one + one
    assert stamps.phase_ms() is None  # the CPU's ring stamps nothing


class _StandInGraph:
    """A captured step stood in for: its replay runs the iteration."""

    def __init__(self, prog, update):
        self.prog, self.update = prog, update

    def replay(self):
        self.prog.totals[self.update] = self.prog.iteration(self.update)


def test_stage_and_replay_spans_nest_inside_a_dispatch(program, monkeypatch):
    """The card's path of ``run``, stood in for at the graphs, the staging
    and the iteration: each step's stage and replay spans inside the
    dispatch's."""
    monkeypatch.setattr(program.state, "device", torch.device("cuda"))
    monkeypatch.setattr(program, "stage", lambda idx, seed: bool(seed % 2))
    monkeypatch.setattr(program, "iteration", lambda update: torch.tensor(float(update)))
    for update in (False, True):
        monkeypatch.setitem(program.graphs, update, _StandInGraph(program, update))
        monkeypatch.setitem(program.launches, update, _build.GraphLaunches())
    before = tracing.totals()
    with _Profiled() as p:
        total = program.run(np.array([[4, 5], [0, 2], [1, 3]]), [1, 2, 3])
    assert total.item() == 1.0  # the last step's, an update
    spans = _mine(p.records, {"train.dispatch", "train.stage", "train.replay"})
    dispatch = [r for r in spans if r.name == "train.dispatch"]
    assert len(dispatch) == 1
    inner = sorted((r for r in spans if r.name != "train.dispatch"), key=lambda r: r.start_ns)
    assert [r.name for r in inner] == ["train.stage", "train.replay"] * 3
    for r in inner:
        assert r.parent == dispatch[0].id
        assert dispatch[0].start_ns <= r.start_ns <= r.end_ns <= dispatch[0].end_ns
    after = tracing.totals()
    for name, n in (("train.dispatch", 1), ("train.stage", 3), ("train.replay", 3)):
        assert after[name].count - before.get(name, tracing.Total(0, 0.0)).count == n


def test_the_cpu_step_runs_the_iteration_with_no_replay_span(program):
    before = tracing.totals().get("train.replay", tracing.Total(0, 0.0)).count
    program.run(np.array([[0, 1]]), [5])
    assert tracing.totals().get("train.replay", tracing.Total(0, 0.0)).count == before
    assert not program.graphs


# ------------------------------------------------------ serving, predict


@pytest.fixture(scope="module")
def handle():
    yolo = YOLO("yolo11n", nc=NC, imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    yolo._ensure_built()
    return yolo


def _frames(n=6):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, (40 + 4 * i, 64, 3), np.uint8) for i in range(n)]


def test_engine_spans_on_the_cpu(handle):
    eng = Engine(handle, max_batch=4, max_wait_ms=200.0)
    with _Profiled() as p:
        eng.warmup([4])
        with eng:
            t0 = time.time_ns()
            futs = [eng.submit(im) for im in _frames()]
            for f in futs:
                f.result(timeout=120)
            t1 = time.time_ns()
    by = {n: _mine(p.records, {n}) for n in ("serve.queue_wait", "serve.capture")}
    # bucket 4 by warmup(), any other bucket by the dispatcher that first needs it
    assert len(by["serve.capture"]) == len(eng._programs)
    assert all(r.parent is None for r in by["serve.capture"])
    # one wait a request, in the order of their submits, from a submit to
    # its dequeue on the dispatcher's thread
    waits = sorted(by["serve.queue_wait"], key=lambda r: r.rid)
    assert [r.rid for r in waits] == list(range(6))
    assert [r.start_ns for r in waits] == sorted(r.start_ns for r in waits)
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 and r.parent is None for r in waits)
    s = eng.stats()
    assert s["completed"] == 6 and s["batches"] >= 2
    longest = max((r.end_ns - r.start_ns) * 1e-6 for r in waits)
    assert 0 <= s["queue_wait_p50_ms"] <= s["queue_wait_p95_ms"] <= longest + 1e-3


def test_serve_stats_keep_their_newest_entries():
    s = ServeStats()
    sizes = list(range(3000))
    for i in sizes:
        s.batch_sizes.append(i % 32 + 1)
        s.latencies_ms.append(float(i))
        s.queue_wait_ms.append(float(3000 - i))
    assert len(s.batch_sizes) == len(s.latencies_ms) == len(s.queue_wait_ms) == WINDOW
    snap = s.snapshot()
    lat = sorted(float(i) for i in sizes[-WINDOW:])
    wait = sorted(float(3000 - i) for i in sizes[-WINDOW:])
    assert snap["p50_ms"] == lat[WINDOW // 2]
    assert snap["p95_ms"] == lat[int(WINDOW * 0.95)]
    assert snap["queue_wait_p50_ms"] == wait[WINDOW // 2]
    assert snap["queue_wait_p95_ms"] == wait[int(WINDOW * 0.95)]
    assert snap["avg_batch"] == sum(i % 32 + 1 for i in sizes[-WINDOW:]) / WINDOW
    assert "queue_wait_p50_ms" not in ServeStats().snapshot()


def test_stats_endpoint_gives_the_queue_wait(handle):
    eng = Engine(handle, max_batch=2, max_wait_ms=5.0)
    server = serve_http(eng, host="127.0.0.1", port=0, block=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for im in _frames(3):
            eng.submit(im).result(timeout=120)
        url = f"http://127.0.0.1:{server.server_address[1]}/stats"
        with urllib.request.urlopen(url, timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()
        thread.join(timeout=30)
    assert stats["completed"] == 3
    assert 0 <= stats["queue_wait_p50_ms"] <= stats["queue_wait_p95_ms"]


def test_predict_spans(handle):
    with _Profiled() as p:
        out = handle.predict(_frames(5), batch_size=2)
    assert len(out) == 5
    names = [r.name for r in p.records if r.name.startswith("predict.")]
    assert names == ["predict.prepare"] * 3  # one a batch of two


# ---------------------------------------------------------------- Trainer


def test_profiled_epoch_runs_the_program_and_writes_its_spans(tmp_path, capsys):
    """profile_steps traces the step program's dispatches (cut at the
    trace's steps) and writes the program's spans into the trace, on its
    axis; time_phases' line gains the epoch's stage time a step."""
    data_yaml = make_dataset(tmp_path, n_train=16, n_val=4, imgsz=64, nc=2)
    cfg = TrainConfig(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=64, batch=4,
                      amp=False, close_mosaic=0, device="cpu", seed=0, val=False,
                      project=str(tmp_path / "runs"), name="prof", max_boxes=16,
                      warmup_epochs=0.5, workers=1, profile_steps=2, time_phases=True)
    t = Trainer(cfg)
    before = tracing.totals().get("train.dispatch", tracing.Total(0, 0.0)).count
    t.train()
    # the epoch's 4 steps, cut at steps 1 and 3: three dispatches
    assert tracing.totals()["train.dispatch"].count - before == 3
    trace = json.loads((t.run.path / "profile" / "trace.json").read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("cat") == "dyd_span"]
    assert [e["name"] for e in spans if e["name"] != "train.dispatch"] == \
        ["train.stage"] * 2 and sum(e["name"] == "train.dispatch" for e in spans) == 1
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    dispatch = next(e for e in spans if e["name"] == "train.dispatch")
    inside = [e for e in ops if dispatch["ts"] <= e["ts"] <= dispatch["ts"] + dispatch["dur"]]
    assert len(inside) > 0.9 * len(ops)  # the trace's operators run inside the dispatch
    out = capsys.readouterr().out
    assert "(3 program spans)" in out
    line = next(ln for ln in out.splitlines() if ln.strip().startswith("phases:"))
    assert "steps " in line and " ms a step" in line


def test_profiled_trace_starts_after_each_graph_is_captured(tmp_path, monkeypatch):
    """Under accumulation (nbs twice the batch) the epoch's steps alternate
    between a step without the update and one with it, each kind its own
    graph on the card, captured after its WARMUP_RUNS eager steps: the
    trace starts after the later capture."""
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=2, imgsz=64, nc=2)
    cfg = TrainConfig(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=64, batch=4, nbs=8,
                      amp=False, close_mosaic=0, device="cpu", seed=0, val=False,
                      project=str(tmp_path / "runs"), name="acc", max_boxes=16, workers=1,
                      profile_steps=2)
    t = Trainer(cfg)
    assert t.accumulate == 2
    updates = [t.state.next_hyper() for _ in range(16)]  # the steps' kinds, in order
    captured = max([i for i, u in enumerate(updates) if u == kind][step_graph.WARMUP_RUNS]
                   for kind in (False, True))
    fresh = types.SimpleNamespace(graphs={})
    assert t._profile_start(fresh, 64) == 1  # the CPU captures nothing
    monkeypatch.setattr(t, "device", torch.device("cuda"))  # the card's rule
    assert t._profile_start(fresh, 64) == captured + 1 == 8
    assert t._profile_start(fresh, 9) == 7  # as far as the epoch allows
    assert t._profile_start(types.SimpleNamespace(graphs={True: None}), 64) == 1

"""The port's Streamlit app and training wrappers against the JAX
package's: ``app.main()`` and both pages under the recording stub
(tests/fake_streamlit.py) make the same calls but for the device strings
listed below; the ``core.training`` cases of tests/test_core_training.py on
the port; the training page's launch loop; ``run_yolo_training_stream`` in a
worker thread training yolo11n on the CPU on the dataset the port's step 8
wrote; and every new module imported with JAX and the JAX package
blocked."""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tests.fake_streamlit import FakeStreamlit
from tests.torch_deadline import LIMIT, _deadline, _deadline_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import synth_annotations_torch as synth  # noqa: E402

# the only strings in which the port's pages differ from the JAX package's
DEVICE_STRINGS = [
    ("YOLO Data & Training Platform (TPU)", "YOLO Data & Training Platform (GPU)"),
    ("YOLO 训练平台（TPU）", "YOLO 训练平台（GPU）"),
    ("→ TPU训练 →", "→ GPU训练 →"),
    ("TPU / 设备信息", "GPU / 设备信息"),
    ("TPU上执行mosaic/HSV/flip", "GPU上执行mosaic/HSV/flip"),
]
SUMMARY = {"available": True, "platform": "gpu", "detail": "1 x card",
           "devices": ["card:0"], "count": 1}
PACKAGES = ("deal_yolo_daya_tpu", "deal_yolo_daya_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _import(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _plain(value):
    """A recorded argument with callables (format_func lambdas) blanked;
    other objects (the export zip's buffer) count by their type."""
    if callable(value):
        return "<callable>"
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _record(pkg: str, drive, monkeypatch, overrides=None):
    """The calls one package's app makes under the stub for ``drive``."""
    st = FakeStreamlit()
    st.session_state["run_id"] = "20260101_000000"
    st.overrides.update(overrides or {})
    monkeypatch.setitem(sys.modules, "streamlit", st)
    monkeypatch.setattr(_import(pkg, "ui.pages.training"), "get_cuda_summary", lambda: SUMMARY)
    drive(pkg)
    return json.dumps([(name, _plain(list(args)), _plain(kwargs))
                       for name, args, kwargs in st.calls], ensure_ascii=False,
                      default=lambda o: str(o) if isinstance(o, Path) else type(o).__name__), st


def _main(pkg):
    _import(pkg, "app").main()


def _processing(pkg):
    _import(pkg, "app").init_session_state()
    sys.modules["streamlit"].session_state["input_ready"] = True
    _import(pkg, "ui.pages.processing").render_processing_pipeline()


def _training(pkg):
    _import(pkg, "app").init_session_state()
    _import(pkg, "ui.pages.training").render_training_platform()


def _visualization(pkg):
    run = Path.cwd() / "run1"
    run.mkdir(exist_ok=True)
    (run / "results.csv").write_text("epoch,train/box_loss,metrics/mAP50(B)\n0,1.0,0.5\n",
                                     encoding="utf-8")
    (run / "args.yaml").write_text("epochs: 1\n", encoding="utf-8")
    _import(pkg, "ui.components").render_run_visualization(run)


@pytest.mark.parametrize("drive,overrides", [
    (_main, None),
    (_main, {"选择功能模块": "YOLO 训练平台"}),
    (_processing, None),
    (_training, {"开始训练": True}),
    (_visualization, None),
], ids=["main-processing", "main-training", "processing-steps", "training-no-data",
        "run-visualization"])
def test_pages_record_the_jax_calls(drive, overrides, monkeypatch, tmp_path):
    """Both packages' pages, driven alike in one directory, record the same
    calls once the listed device strings are swapped in the JAX record; each
    swap that the page's text holds is made."""
    monkeypatch.chdir(tmp_path)
    want, _ = _record(PACKAGES[0], drive, monkeypatch, overrides)
    got, st = _record(PACKAGES[1], drive, monkeypatch, overrides)
    for old, new in DEVICE_STRINGS:
        assert old not in got
        want = want.replace(old, new)
    assert got == want
    assert st.calls


def test_device_strings_are_the_only_differences():
    """The listed strings are each in the JAX package's pages and each
    replaced in the port's."""
    text = {pkg: "".join((ROOT / pkg / f).read_text(encoding="utf-8")
                         for f in ("app.py", "ui/pages/training.py")) for pkg in PACKAGES}
    for old, new in DEVICE_STRINGS:
        assert old in text[PACKAGES[0]] and new in text[PACKAGES[1]]
        assert old not in text[PACKAGES[1]]


# ------------------------------------- tests/test_core_training.py on the port

def test_stream_queue_writer_line_buffering():
    from deal_yolo_daya_tpu_torch.core.training import StreamQueueWriter

    q: "queue.Queue" = queue.Queue()
    w = StreamQueueWriter(q)
    w.write("partial")
    assert q.empty()
    w.write(" line\nsecond\nthird-without-newline")
    assert q.get_nowait() == "partial line"
    assert q.get_nowait() == "second"
    assert q.empty()
    w.flush()
    assert q.get_nowait() == "third-without-newline"
    w.close()
    assert q.empty()
    assert not w.isatty()


def test_epoch_regex():
    from deal_yolo_daya_tpu_torch.core.training import _extract_epoch_info

    assert _extract_epoch_info("Epoch 3/100  box 0.5") == (3, 100)
    assert _extract_epoch_info("epoch 12 / 40") == (12, 40)
    assert _extract_epoch_info("no epochs here") is None
    assert _extract_epoch_info("") is None


def test_dependency_probes():
    """The port's probes name modules only: torch and the data stack, no
    JAX; a missing card is not a missing dependency."""
    from deal_yolo_daya_tpu_torch.core.training import check_train_dependencies
    from deal_yolo_daya_tpu_torch.core.utils import check_requirements, get_cuda_summary
    from deal_yolo_daya_tpu_torch.parallel.mesh import device_summary

    assert check_train_dependencies() == []
    assert check_requirements() == []
    assert get_cuda_summary() == device_summary()
    if not torch.cuda.is_available():
        assert get_cuda_summary()["available"] is False


# ---------------------------------------------------------- the training path

@pytest.fixture(scope="module")
def step8_yaml(tmp_path_factory):
    """The data.yaml the port's step 8 writes for the animals category."""
    from deal_yolo_daya_tpu_torch.core import processor

    root = tmp_path_factory.mktemp("app_data")
    fx = synth.pipeline_inputs(root / "inputs", n_images=24, seed=2, sides=(64, 129),
                               n_dup=2, n_corrupt=2, n_null=2, n_ref=2, high_every=12)
    run = synth.run_pipeline(processor, fx, root / "run")
    assert run["counts"] == fx["counts"]
    return run["datasets"]["animals"] / "data.yaml"


def test_training_page_launch_hands_the_page_kwargs(step8_yaml, monkeypatch, tmp_path):
    """'开始训练' on the port's page starts ``run_yolo_training_stream`` in a
    thread with ``synth.page_train_kwargs`` (the page's defaults), drains
    its queue to LOG_DONE, moves the progress bar and reports the run."""
    from deal_yolo_daya_tpu_torch.core.training import LOG_DONE
    from deal_yolo_daya_tpu_torch.ui.pages import training as page

    monkeypatch.chdir(tmp_path)
    seen = {}

    def fake_stream(model, data_yaml, kwargs, env, log_queue, holder):
        seen.update(model=model, data=data_yaml, kwargs=kwargs, env=env,
                    thread=threading.current_thread())
        log_queue.put("Epoch 1/2 box 1.0")
        log_queue.put("Epoch 2/2 box 0.9")
        holder["save_dir"] = str(tmp_path / "run")
        log_queue.put(LOG_DONE)

    monkeypatch.setattr(page, "run_yolo_training_stream", fake_stream)
    _, st = _record(PACKAGES[1], _training, monkeypatch, {
        "开始训练": True, "train_dataset_root": str(step8_yaml.parent)})
    assert seen["model"] == "yolo11n" and seen["data"] == str(step8_yaml)
    assert seen["kwargs"] == synth.page_train_kwargs("runs/train_platform/runs", "train")
    assert seen["env"] == {} and seen["thread"] is not threading.main_thread()
    assert ("progress", (1.0,), {}) in st.calls
    assert st.session_state["train_last_run"] == str(tmp_path / "run")
    logs = list((tmp_path / "runs" / "train_platform" / "logs").glob("*.log"))
    assert logs and "Epoch 2/2" in logs[0].read_text(encoding="utf-8")


def test_stream_training_in_a_thread_on_step8_data(step8_yaml, tmp_path):
    """The page's call path for real: yolo11n, 64 px, one epoch, batch 4, on
    the CPU, in a worker thread; the log lines reach the queue, LOG_DONE
    ends it, and the run directory holds the run's files."""
    from deal_yolo_daya_tpu_torch.core.training import (
        LOG_DONE, _extract_epoch_info, collect_run_dirs, run_yolo_training_stream)

    project = tmp_path / "runs"
    kwargs = synth.page_train_kwargs(str(project), "thread", epochs=1, imgsz=64, batch=4,
                                     device="cpu")
    log_queue: "queue.Queue" = queue.Queue()
    holder: dict = {}
    thread = threading.Thread(target=run_yolo_training_stream, daemon=True, args=(
        "yolo11n", str(step8_yaml), kwargs, {}, log_queue, holder))
    thread.start()
    lines, end = [], time.monotonic() + LIMIT / 2
    while (item := log_queue.get(timeout=max(0.0, end - time.monotonic()))) is not LOG_DONE:
        lines.append(item)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert "error" not in holder, holder.get("error")
    assert any(_extract_epoch_info(ln) == (1, 1) for ln in lines), lines[-20:]
    save_dir = Path(holder["save_dir"])
    for name in ("results.csv", "args.yaml", "weights/last.pt", "weights/best.pt"):
        assert (save_dir / name).exists(), name
    assert collect_run_dirs(str(project)) == [save_dir.resolve()]


def test_stream_training_spawns_ranks_from_a_thread(step8_yaml, tmp_path, monkeypatch):
    """``device="2"`` from the page's worker thread: the thread's Trainer
    spawns the second rank (two CPU devices), both train, rank 0 writes."""
    from deal_yolo_daya_tpu_torch.core.training import LOG_DONE, run_yolo_training_stream

    monkeypatch.setenv("DYD_CPU_DEVICES", "2")
    kwargs = synth.page_train_kwargs(str(tmp_path / "runs"), "dp", epochs=1, imgsz=64,
                                     batch=4, device="2", dist_timeout_s=LIMIT / 2)
    log_queue: "queue.Queue" = queue.Queue()
    holder: dict = {}
    thread = threading.Thread(target=run_yolo_training_stream, daemon=True, args=(
        "yolo11n", str(step8_yaml), kwargs, {}, log_queue, holder))
    thread.start()
    lines, end = [], time.monotonic() + LIMIT / 2
    while (item := log_queue.get(timeout=max(0.0, end - time.monotonic()))) is not LOG_DONE:
        lines.append(item)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert "error" not in holder, holder.get("error")
    assert any("ranks=2" in ln for ln in lines), lines
    assert any(ln.startswith("Epoch 1/1") for ln in lines), lines
    assert (Path(holder["save_dir"]) / "results.csv").exists()


def test_stream_training_error_reaches_the_holder(tmp_path):
    """A run that fails (a 1x2 mesh with no devices visible, and no
    data.yaml) puts its error in the holder and still ends with LOG_DONE."""
    from deal_yolo_daya_tpu_torch.core.training import LOG_DONE, run_yolo_training_stream

    log_queue: "queue.Queue" = queue.Queue()
    holder: dict = {}
    run_yolo_training_stream("yolo11n", str(tmp_path / "missing.yaml"), {"device": "1x2"}, {},
                             log_queue, holder)
    items = []
    while not log_queue.empty():
        items.append(log_queue.get_nowait())
    assert items[-1] is LOG_DONE
    assert isinstance(holder["error"], Exception)


_BLOCKED_IMPORTS = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        for root in ("jax", "jaxlib", "flax", "optax", "deal_yolo_daya_tpu"):
            if name == root or name.startswith(root + "."):
                raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import importlib
for name in sys.argv[2:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "deal_yolo_daya_tpu"))
assert not bad, bad
print("imported", len(sys.argv) - 2)
"""


def test_new_modules_import_without_jax():
    """Every module of the data/UI surface imports with JAX and the JAX
    package blocked."""
    pkg = ROOT / "deal_yolo_daya_tpu_torch"
    names = ["deal_yolo_daya_tpu_torch.config", "deal_yolo_daya_tpu_torch.app"]
    for sub in ("utils", "runtime", "datakit", "core", "ui", "ui/pages"):
        for f in sorted((pkg / sub).glob("*.py")):
            mod = ("deal_yolo_daya_tpu_torch." + sub.replace("/", ".")
                   + ("" if f.stem == "__init__" else "." + f.stem))
            names.append(mod)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS, str(ROOT), *names],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == f"imported {len(names)}"

"""The harness finds every configuration, cell, driver and per-layer metric
by name, and BENCHMARK.json keeps the contract's rules."""

import json
import re
import subprocess
import sys

import pytest

from benchmark import run as R

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found(cfg):
    assert NAME.match(cfg["name"])
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = R.load_json(R.ROOT / cfg["file"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["model"] == cfg["name"]
    assert cfg["reduced"] == []


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    wl = R.load_json(R.HERE / "workloads" / f"{cell['name']}.json")
    assert wl["config"] == cell["config"]
    assert (R.HERE / "configs" / f"{wl['config']}.json").is_file()
    assert hasattr(R.load_module(R.HERE / "drivers" / f"{wl['driver']}.py", "d"), "run")
    e2e = {m["name"] for m in R.cell_metrics(BENCH, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert R.cell_metrics(BENCH, cell["name"], "per_layer")
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_rules(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        reader = R.load_module(R.HERE / "metrics" / f"{metric['name']}.py", "m")
        assert callable(reader.read)


def test_every_name_has_its_file_and_every_file_runs():
    """Each name in BENCHMARK.json has its file. A cell or metric file that
    BENCHMARK.json does not list yet (the serving and predict cells, kept
    for a later PR: PERF.md) still names a configuration and a driver that
    exist, or has a reader."""
    cells = {p.stem for p in (R.HERE / "workloads").glob("*.json")}
    assert {c["name"] for c in BENCH["workloads"]} <= cells
    assert {p.stem for p in (R.HERE / "configs").glob("*.json")} == \
        {c["name"] for c in BENCH["configs"]}
    readers = {p.name[:-3] for p in (R.HERE / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= readers
    for name in cells:
        wl = R.load_json(R.HERE / "workloads" / f"{name}.json")
        assert (R.HERE / "configs" / f"{wl['config']}.json").is_file()
        assert (R.HERE / "drivers" / f"{wl['driver']}.py").is_file()
    for name in readers:
        assert callable(R.load_module(R.HERE / "metrics" / f"{name}.py", "m").read)


def test_result_line_keys(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "a card")
    ctx = R.Context("yolo11n.train.b32", 1, 1.0, False, "cpu")
    ctx.e2e.update(setup_s=1.5, train_img_s=560.0)
    ctx.check("fg", 0.0)
    line = R.result_line(ctx, BENCH)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "train_img_s"}
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(R.HERE / "run.py"), "--workload",
                          "yolo11n.predict.b32", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=R.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""

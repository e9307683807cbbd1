"""The YOLOv10 cell on the CPU at a tiny size, traced: the driver's
protocol end to end with its checks and its readers; the v10 costs against
the published counts; the fp8 control's flow."""

import math

import pytest

from benchmark import run as R
from benchmark.lib.costs_v10 import v10_costs
from benchmark.tests.conftest import tiny

CELL = "yolov10m.train.b32"


def test_costs_match_the_published_flops():
    """The deployed forward (one-to-one head) at 640: the paper's 59.1 GFLOP
    for yolov10m; the training forward counts both heads."""
    cfg = R.load_json(R.HERE / "configs" / "yolov10m.json")
    deployed, train = v10_costs(cfg, 640, False), v10_costs(cfg, 640)
    assert abs(deployed["forward_flops"] / 1e9 - 59.1) < 0.5
    assert train["forward_flops"] / 1e9 == pytest.approx(cfg["forward_gflops_640"])
    assert train["attention_calls"] == [(1, 400, 4, 36, 72)]


def test_the_cell_runs_traced_on_the_cpu(cpu_threads):
    ctx = R.execute(CELL, 31, 1.0, True, device="cpu", overrides=tiny(CELL))
    assert ctx.attempted > 0 and ctx.failed == 0
    names = [n for n, _, _ in ctx.checks]
    assert names == ["fg", "fg.o2o", "bn.start", "grad.start", "change.start", "bn", "grad",
                     "change"]
    assert all(v == v for _, v, _ in ctx.checks)
    assert ctx.e2e["train_img_s"] > 0 and ctx.e2e["setup_s"] > 0
    for path in sorted((R.HERE / "metrics").glob("*.train_v10.py")):
        value = R.load_module(path, f"m_{path.stem}").read(ctx)
        assert value is None or math.isfinite(value), path.name
    assert R.load_module(R.HERE / "metrics" / "mfu_pct.train_v10.py", "m").read(ctx) > 0


def test_the_control_runs(cpu_threads):
    ctx = R.execute(CELL, 32, 1.0, False, device="cpu", control="fp8", overrides=tiny(CELL))
    assert [n for n, _, _ in ctx.checks][:2] == ["fg", "fg.o2o"]

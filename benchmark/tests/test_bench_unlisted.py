"""The cells kept for a later PR, which BENCHMARK.json does not list yet
(PERF.md, Open questions), run end to end on the CPU at a tiny size,
traced, with every metric reader of their kind; the serving sweep runs at
one rate. So their code cannot drift from the program unseen."""

import json
import math

import pytest

from benchmark import run as R
from benchmark import sweep as S
from benchmark.tests.conftest import tiny

LISTED = {c["name"] for c in json.loads((R.ROOT / "BENCHMARK.json").read_text())["workloads"]}
UNLISTED = sorted({p.stem for p in (R.HERE / "workloads").glob("*.json")} - LISTED)
E2E = {"serve_open": {"setup_s", "serve_p95_ms", "serve_img_s"},
       "predict": {"setup_s", "predict_img_s"}}


def test_the_unlisted_cells():
    assert UNLISTED == ["yolo11n.predict.b32", "yolo11n.serve.open"]


@pytest.mark.parametrize("name", UNLISTED)
def test_unlisted_cell_runs_traced(name, cpu_threads):
    ctx = R.execute(name, 31, 1.0, True, device="cpu", overrides=tiny(name))
    assert ctx.attempted > 0 and ctx.failed == 0
    assert ctx.checks and all(v == v for _, v, _ in ctx.checks)
    e2e = E2E[ctx.wl["driver"]]
    assert e2e <= set(ctx.e2e) and all(ctx.e2e[m] > 0 for m in e2e)
    assert ctx.tr is not None and ctx.breakdown is not None
    kind = name.split(".")[1]
    readers = sorted((R.HERE / "metrics").glob(f"*.{kind}.py"))
    assert readers
    for path in readers:
        value = R.load_module(path, f"m_{path.stem}").read(ctx)
        assert value is None or math.isfinite(value), path.name


def test_sweep_runs(cpu_threads):
    rows = S.sweep("yolo11n.serve.open", 5, 0.5, [40.0], threads=2, device="cpu",
                   overrides=tiny("yolo11n.serve.open"))
    assert len(rows) == 1 and rows[0]["unresolved"] == 0
    assert rows[0]["offered"] > 0 and rows[0]["completed_share"] > 0

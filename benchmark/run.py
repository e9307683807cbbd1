#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``: it names its
configuration (``benchmark/configs/<config>.json``), its driver
(``benchmark/drivers/<driver>.py``) and its traffic. ``BENCHMARK.json`` at
the checkout's root says which end-to-end metrics (``--trace 0``) and which
per-layer metrics (``--trace 1``, each read by ``benchmark/metrics/
<metric>.py``) the cell reports. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
and, traced, ``breakdown``; the numbers compared for ``correct`` are the
last lines of standard error and the ``checks`` key of that line.

The run needs the program (``deal_yolo_daya_tpu_torch``) and as many CUDA
cards as the cell asks for; without them it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# names whose presence in sys.modules fails a run (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "deal_yolo_daya_tpu")


class RunError(RuntimeError):
    """A run that cannot report a result."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file name."""
    if not path.is_file():
        raise RunError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, workload: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload`` reports:
    those that list it, and those with no ``workloads`` key."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules that a run may not hold."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def setup_env() -> None:
    """Caches inside the checkout at fixed paths; no library may load JAX."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))


class Context:
    """What a driver and the metric readers share for one run."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device: str,
                 control: Optional[str] = None, overrides: Optional[Dict] = None):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), trace
        self.wl = load_json(HERE / "workloads" / f"{name}.json")
        for k, v in (overrides or {}).items():
            self.wl[k] = v
        self.cfg = load_json(HERE / "configs" / f"{self.wl['config']}.json")
        self.device = device
        self.control = control
        self.counters: Dict = {}
        self.e2e: Dict[str, float] = {}
        self.checks: List = []   # (name, value, limit)
        self.readings: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.tr = None           # lib.trace.Trace of a traced run
        self.breakdown = None
        self.t_start = T_START

    def limit(self, name: str) -> float:
        return float(self.wl["limits"][name])

    def check(self, name: str, value: float) -> None:
        """Compare one number with its limit in the cell's file."""
        self.readings[name] = float(value)
        self.checks.append((name, float(value), self.limit(name)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v == v and v <= lim for _, v, lim in self.checks)


def execute(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            control: Optional[str] = None, overrides: Optional[Dict] = None) -> Context:
    """Run the cell's driver; the context then holds every reading."""
    ctx = Context(name, seed, seconds, trace, device, control, overrides)
    driver = load_module(HERE / "drivers" / f"{ctx.wl['driver']}.py",
                         f"benchmark_driver_{ctx.wl['driver']}")
    driver.run(ctx)
    return ctx


def per_layer(ctx: Context, entries: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"benchmark_metric_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(ctx: Context, bench: Dict) -> Dict:
    import torch

    kind = "per_layer" if ctx.trace else "end_to_end"
    entries = cell_metrics(bench, ctx.name, kind)
    if ctx.trace:
        metrics = per_layer(ctx, entries)
    else:
        metrics = {m["name"]: {"value": float(ctx.e2e[m["name"]]), "unit": m["unit"]}
                   for m in entries}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(ctx.wl.get("chips", 1)), "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if ctx.trace:
        device["busy_s"] = ctx.tr.busy_s
        device["window_s"] = ctx.tr.window_s
    line = {"correct": ctx.correct, "attempted": int(ctx.attempted), "failed": int(ctx.failed),
            "metrics": metrics, "device": device}
    if ctx.trace and ctx.breakdown is not None:
        line["breakdown"] = ctx.breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in ctx.checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = load_json(HERE / "workloads" / f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl.get("chips", 1)):
        print(f"benchmark: needs {wl.get('chips', 1)} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    ctx = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(ctx, bench)
    for n, v, lim in ctx.checks:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except RunError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        code = 2
    sys.exit(code)

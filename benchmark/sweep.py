#!/usr/bin/env python3
"""Find the serving knee once: the highest offered rate the Engine sustains
without a growing backlog, by an open loop at each of a list of rates, in
one process on the card (one Engine, warmed once).

    python3 benchmark/sweep.py --workload yolo11n.serve.open --seconds 8 \
        --rates 400 500 600 700 800 900

For each rate it prints one JSON line: offered and completed in the window,
the p50 and p95 latency from the due time, the p95 of the window's first
and second halves (a backlog that grows shows as a second half slower than
the first), and the sender threads' lateness. The cell's ``rate`` is set by
hand from these readings (0.8 x the knee); the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as R  # noqa: E402


def sweep(workload: str, seed: int, seconds: float, rates, threads=None, device: str = "cuda",
          overrides=None):
    """The open loop at each of ``rates`` -> one dict of readings a rate."""
    import torch

    from deal_yolo_daya_tpu_torch.api import YOLO
    from deal_yolo_daya_tpu_torch.serve import Engine

    from benchmark.lib import traffic
    from benchmark.reference import model as ref

    serve = R.load_module(R.HERE / "drivers" / "serve_open.py", "sweep_serve_open")
    ctx = R.Context(workload, seed, seconds, False, device, overrides=overrides)
    wl, cfg = ctx.wl, ctx.cfg
    dev = torch.device(device)
    torch.set_num_threads(wl["intra_op_threads"])
    pool = traffic.image_pool(seed, wl["pool"], dev)
    handle = YOLO(cfg["model"], nc=cfg["nc"], imgsz=wl["imgsz"], device=dev)
    handle._ensure_built().load_state_dict(ref.make_weights(cfg, seed, dev, wl["imgsz"],
                                                            wl["weights"]))
    engine = Engine(handle, max_batch=wl["max_batch"], conf=wl["conf"], iou=wl["iou"])
    engine.warmup()
    engine.start()
    threads_n = threads or wl["sender_threads"]
    rows = []
    try:
        for rate in rates:
            due = traffic.arrivals(seed, rate, seconds)
            pick = traffic.choices(seed, len(due), len(pool))
            t0, senders, start, done, _, _ = serve.offer(
                engine, [pool[j] for j in pick], due, threads_n)
            for t in senders:
                t.join()
            t_end = t0 + seconds
            time.sleep(max(t_end - time.perf_counter(), 0.0))
            in_window = int(np.sum(done <= t_end))
            serve._await(done, 60.0)
            lat = (done - (t0 + due)) * 1e3
            half = due < seconds / 2
            rows.append({
                "rate": rate, "threads": threads_n, "offered": len(due),
                "completed_in_window": in_window, "completed_share": in_window / len(due),
                "p50_ms": float(np.nanmedian(lat)), "p95_ms": float(np.nanquantile(lat, 0.95)),
                "p95_first_half_ms": float(np.nanquantile(lat[half], 0.95)),
                "p95_second_half_ms": float(np.nanquantile(lat[~half], 0.95)),
                "late_p95_ms": float(np.nanquantile((start - (t0 + due)) * 1e3, 0.95)),
                "unresolved": int(np.isnan(done).sum())})
            print(json.dumps(rows[-1]), flush=True)
            time.sleep(1.0)
    finally:
        engine.shutdown()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="yolo11n.serve.open")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--threads", type=int, default=None,
                    help="sender threads (default: the cell's)")
    args = ap.parse_args()
    R.setup_env()
    import torch

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    sweep(args.workload, args.seed, args.seconds, args.rates, args.threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Serving-engine benchmark for the PyTorch port: sustained throughput and
latency percentiles of ``deal_yolo_daya_tpu_torch.serve.Engine`` (one CUDA
graph a bucket) under client load on the card.

N client threads submit for --seconds after ``warmup()`` has captured every
bucket: closed loop with --rate 0 (each client submits its next image when
the last resolved), else open loop at an aggregate --rate requests/s. As in
``tools/bench_serve.py``, the images are imgsz x imgsz (pre-letterboxed, so
the clients' resize work does not set the rate); random weights from seed
0. Prints one JSON line: img/s, the clients' p50/p95 latency, the batcher's
avg_batch and pad_fraction, errors, and the card's name and power limit.

Usage (card): python3 tools/bench_serve_torch.py [--model yolo11] [--scale n]
              [--imgsz 640] [--max-batch 32] [--clients 16] [--rate 0]
              [--seconds 20]
CPU smoke:    python3 tools/bench_serve_torch.py --device cpu --imgsz 64 \
              --seconds 3 --max-batch 4
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def _counters(snapshot: Dict[str, float]) -> Dict[str, float]:
    """The engine's running totals in a ``stats()`` snapshot, padded slots
    recovered from pad_fraction = padded / (padded + completed)."""
    done, pf = snapshot["completed"], snapshot["pad_fraction"]
    return {"completed": done, "errors": snapshot["errors"], "batches": snapshot["batches"],
            "requests": snapshot["requests"],
            "padded": round(pf * done / (1.0 - pf)) if pf < 1.0 else 0}


def drive_load(engine, images: Sequence[np.ndarray], clients: int = 16,
               seconds: float = 8.0, rate: float = 0.0) -> Dict[str, float]:
    """Load a started engine from ``clients`` threads for ``seconds``.

    ``rate`` 0 is closed loop: each client submits its next image when the
    last one resolved. A positive ``rate`` is open loop: the clients submit
    ``rate`` requests a second in all, on a fixed schedule, without waiting
    for results. Returns the window's completed img/s and the clients'
    request latency (letterbox included) as ``client_p50_ms`` and
    ``client_p95_ms``; the window's ``completed``, ``errors``, ``batches``,
    ``avg_batch`` and ``pad_fraction`` as differences of the engine's
    ``stats()`` before and after it; and the engine's own ``p50_ms`` and
    ``p95_ms`` (from the end of the letterbox, over its last 2048
    requests)."""
    stop = threading.Event()
    lock = threading.Lock()
    done: List[Tuple[float, float]] = []  # (completion time, latency s)
    failed: List[BaseException] = []
    futures: List[Future] = []
    interval = clients / rate if rate > 0 else 0.0

    def record(fut: Future, t0: float) -> None:
        t = time.perf_counter()
        with lock:
            if fut.exception() is None:
                done.append((t, t - t0))
            else:
                failed.append(fut.exception())

    def client(i: int) -> None:
        k = 0
        t_next = time.perf_counter() + interval * i / max(clients, 1)
        while not stop.is_set():
            if interval:
                wait = t_next - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                t_next += interval
            t0 = time.perf_counter()
            try:
                fut = engine.submit(images[(i + k * clients) % len(images)])
            except RuntimeError:
                break  # engine shut down
            fut.add_done_callback(lambda f, t0=t0: record(f, t0))
            if interval:
                with lock:
                    futures.append(fut)
            else:
                try:
                    fut.result(timeout=600)
                except Exception:  # counted by record()
                    pass
            k += 1

    before = _counters(engine.stats())
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    t_end = time.perf_counter()
    for t in threads:
        t.join(timeout=120)
    for fut in list(futures):
        try:
            fut.result(timeout=600)
        except Exception:  # counted by record()
            pass
    # a future resolves just before the engine counts it: wait for the count
    for _ in range(1000):
        stats = engine.stats()
        if stats["completed"] + stats["errors"] >= stats["requests"]:
            break
        time.sleep(0.001)
    after = _counters(stats)
    win = {k: after[k] - before[k] for k in after}
    lat = sorted(ms for t, ms in done)
    in_window = sum(1 for t, _ in done if t <= t_end)
    out = {"imgs_per_s": in_window / (t_end - t0), "seconds": t_end - t0,
           "clients": clients, "rate": rate, "client_errors": len(failed),
           "completed": win["completed"], "errors": win["errors"], "batches": win["batches"],
           "avg_batch": (win["completed"] + win["errors"]) / max(win["batches"], 1),
           "pad_fraction": win["padded"] / max(win["padded"] + win["completed"], 1)}
    if lat:
        out["client_p50_ms"] = lat[len(lat) // 2] * 1e3
        out["client_p95_ms"] = lat[min(len(lat) - 1, int(len(lat) * 0.95))] * 1e3
    for k in ("p50_ms", "p95_ms"):
        if k in stats:
            out[k] = stats[k]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="n")
    ap.add_argument("--model", default="yolo11", choices=("yolo11", "yolov8", "yolo12"))
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="aggregate req/s (0 = closed loop, as fast as possible)")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from deal_yolo_daya_tpu_torch.api import YOLO
    from deal_yolo_daya_tpu_torch.serve import Engine

    handle = YOLO(f"{args.model}{args.scale}", imgsz=args.imgsz, device=args.device)
    eng = Engine(handle, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    card = card_name() if handle.device.type == "cuda" else "cpu (no card)"
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (args.imgsz, args.imgsz, 3), np.uint8) for _ in range(8)]

    t_w = time.perf_counter()
    eng.warmup()
    print(f"[bench_serve_torch] warmup (every bucket's graph) {time.perf_counter() - t_w:.1f} s",
          file=sys.stderr)
    with eng:
        eng.submit(imgs[0]).result(timeout=600)
        rec = drive_load(eng, imgs, clients=args.clients, seconds=args.seconds, rate=args.rate)
    out = {
        "metric": f"serve_{args.model}{args.scale}_images_per_sec_{args.imgsz}",
        "value": round(rec["imgs_per_s"], 1),
        "unit": "images/sec/card" if handle.device.type == "cuda" else "images/sec on the CPU",
        "clients": args.clients,
        "rate": args.rate,
        "max_batch": args.max_batch,
        "avg_batch": round(rec["avg_batch"], 2),
        "pad_fraction": round(rec["pad_fraction"], 4),
        "p50_ms": round(rec.get("client_p50_ms", 0.0), 2),
        "p95_ms": round(rec.get("client_p95_ms", 0.0), 2),
        "errors": rec["errors"] + rec["client_errors"],
        "device": str(handle.device),
        "card": card,
    }
    print(json.dumps(out))
    print(f"[bench_serve_torch] {out}", file=sys.stderr)


if __name__ == "__main__":
    main()

"""Driver ``serve_open``: ``serve.Engine`` under an open loop.

Set-up makes the weights and the pool of raw images from the seed, builds
the ``YOLO`` handle and ``Engine(max_batch)``, captures every bucket and
sends a short warm stream at the cell's rate. The window offers a Poisson
stream at the cell's fixed rate: each request is due at its time, a fixed
pool of sender threads submits it then (``Engine.submit`` letterboxes on
the sender's thread, as callers' threads do), and it is timed from when it
was due to when its future resolved. ``serve_p95_ms`` is the 95th
percentile of every request due in the window; ``serve_img_s`` the
requests completed inside the window over its length. After the window
every future is awaited (a minute at most), the Engine is shut down, and a
seeded sample of the finished requests, the largest images among them, is
judged against the reference.
"""

from __future__ import annotations

import gc
import sys
import threading
import time

import numpy as np

from benchmark.lib import detections, trace as T, traffic


def offer(engine, images, due, sender_threads: int, sink=None):
    """Send request i at ``t0 + due[i]`` from a pool of threads -> (t0, the
    threads, submit start times, resolve times, whether each failed, submit
    seconds). ``sink(i, image, answer)`` gets each answer as it resolves;
    nothing else keeps it."""
    n = len(due)
    start = np.full(n, np.nan)
    done = np.full(n, np.nan)
    failed = np.zeros(n, bool)
    submit_s = np.zeros(n)
    lock = threading.Lock()
    nxt = [0]
    t0 = time.perf_counter() + 0.05

    def finish(i, fut):
        done[i] = time.perf_counter()
        if fut.exception() is not None:
            failed[i] = True
        elif sink is not None:
            sink(i, images[i], fut.result())

    def sender():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n:
                return
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            start[i] = time.perf_counter()
            try:
                fut = engine.submit(images[i])
            except RuntimeError:  # the engine refused it
                done[i] = time.perf_counter()
                failed[i] = True
                continue
            submit_s[i] = time.perf_counter() - start[i]
            fut.add_done_callback(lambda f, i=i: finish(i, f))

    threads = [threading.Thread(target=sender, daemon=True) for _ in range(sender_threads)]
    for t in threads:
        t.start()
    return t0, threads, start, done, failed, submit_s


def run(ctx) -> None:
    import torch

    from deal_yolo_daya_tpu_torch.api import YOLO
    from deal_yolo_daya_tpu_torch.serve import Engine

    from benchmark.reference import model as ref

    wl, cfg = ctx.wl, ctx.cfg
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    pool = traffic.image_pool(ctx.seed, wl["pool"], dev)
    sd = ref.make_weights(cfg, ctx.seed, dev, wl["imgsz"], wl["weights"])
    if ctx.control:
        detections.control(ctx, sd, pool)
        return
    # each request's letterbox runs on its own sender thread: one intra-op
    # thread each, as a threaded server is deployed
    torch.set_num_threads(wl["intra_op_threads"])
    handle = YOLO(cfg["model"], nc=cfg["nc"], imgsz=wl["imgsz"], device=dev)
    handle._ensure_built().load_state_dict(sd)
    engine = Engine(handle, max_batch=wl["max_batch"], conf=wl["conf"], iou=wl["iou"],
                    **({"max_wait_ms": wl["max_wait_ms"]} if "max_wait_ms" in wl else {}))
    engine.warmup()
    engine.start()
    rate = wl["rate"]
    # a warm stream: every sender thread and bucket has run once
    warm_due = traffic.arrivals(ctx.seed + 1, rate, wl["warm_seconds"])
    warm_pick = traffic.choices(ctx.seed + 1, len(warm_due), len(pool))
    _, threads, _, done, _, _ = offer(engine, [pool[j] for j in warm_pick], warm_due,
                                      wl["sender_threads"])
    for t in threads:
        t.join()
    _await(done, 60.0)
    if cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    ctx.e2e["setup_s"] = time.perf_counter() - ctx.t_start

    window = min(ctx.seconds, wl["trace_seconds"]) if ctx.trace else ctx.seconds
    due = traffic.arrivals(ctx.seed, rate, window)
    pick = traffic.choices(ctx.seed, len(due), len(pool))
    k = wl["check_requests"]
    sampler = detections.Sampler(ctx.seed, (k - k // 8) / len(due), k // 8, len(due))
    before = engine.stats()
    prof = T.start() if ctx.trace else None
    with T.record("window"):
        w0 = time.perf_counter()
        t0, threads, start, done, failed, submit_s = offer(
            engine, [pool[j] for j in pick], due, wl["sender_threads"], sampler.offer)
        for t in threads:
            t.join()
        t_end = t0 + window
        wait = t_end - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
    if prof is not None:
        if cuda:
            torch.cuda.synchronize(dev)
        prof.stop()
    after = engine.stats()
    _await(done, 60.0)
    gave_up = time.perf_counter()
    engine.shutdown()
    if prof is not None:
        ctx.tr = T.Trace(prof)
        # the sender threads' letterbox, timed here: the profiler does not
        # follow threads started inside its window
        ctx.tr.add_host_spans("submit", [(a, a + d) for a, d in zip(start, submit_s) if a == a],
                              w0)
        ctx.breakdown = {"device_ops": ctx.tr.top_ops(), "idle_gaps": ctx.tr.idle_gaps()}

    unresolved = np.isnan(done)
    # a request that never resolved counts as waiting until the run gave up
    lat_ms = (np.where(unresolved, gave_up, done) - (t0 + due)) * 1e3
    completed_in = int(np.sum(done <= t_end))
    late_ms = (start - (t0 + due)) * 1e3
    ctx.e2e["serve_p95_ms"] = float(np.quantile(lat_ms, 0.95, method="higher"))
    ctx.e2e["serve_img_s"] = completed_in / window
    ctx.attempted, ctx.failed = len(due), int(failed.sum() + unresolved.sum())
    padded = _padded(after) - _padded(before)
    served = after["completed"] - before["completed"]
    ctx.counters.update(
        window_s=window, offered=len(due), completed_in_window=completed_in,
        batches=after["batches"] - before["batches"], served=served, padded=padded,
        submit_ms_mean=float(np.mean(submit_s)) * 1e3,
        engine_p95_ms=after.get("p95_ms"))
    print(f"serve: {len(due)} requests at {rate} req/s over {window} s; latency median "
          f"{float(np.median(lat_ms)):.3f} ms, p95 {ctx.e2e['serve_p95_ms']:.3f} ms "
          f"({len(lat_ms)} samples, {int(unresolved.sum())} unresolved); "
          f"sender lateness median {float(np.nanmedian(late_ms)):.3f} ms, p95 "
          f"{float(np.nanquantile(late_ms, 0.95)):.3f} ms, max {float(np.nanmax(late_ms)):.3f} ms",
          file=sys.stderr)
    if cuda:
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    images, served_dets = sampler.picked(k)
    del engine, handle
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    detections.judge(ctx, sd, images, served_dets)


def _padded(stats) -> int:
    done, pf = stats["completed"], stats["pad_fraction"]
    return round(pf * done / (1.0 - pf)) if pf < 1.0 else 0


def _await(done, timeout: float) -> None:
    """Wait until every request resolved, ``timeout`` seconds at most."""
    t_end = time.perf_counter() + timeout
    while np.isnan(done).any() and time.perf_counter() < t_end:
        time.sleep(0.01)

"""Driver ``predict``: offline batch predict, ``YOLO.predict`` on lists of
``batch`` raw arrays from the cell's image pool.

Set-up makes the weights and the pool from the seed, builds the handle and
runs ``warm_calls`` calls. The window repeats ``predict(list of batch
arrays, batch_size=batch, conf)`` for ``--seconds``; each call returns
when its results are on the host. ``predict_img_s`` is the images returned
in the window over its length. A seeded sample of the returned results,
the largest images among them, is then judged against the reference.
"""

from __future__ import annotations

import gc
import time

from benchmark.lib import detections, trace as T, traffic


def run(ctx) -> None:
    import torch

    from deal_yolo_daya_tpu_torch.api import YOLO

    from benchmark.reference import model as ref

    wl, cfg = ctx.wl, ctx.cfg
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    batch = wl["batch"]
    pool = traffic.image_pool(ctx.seed, wl["pool"], dev)
    sd = ref.make_weights(cfg, ctx.seed, dev, wl["imgsz"], wl["weights"])
    if ctx.control:
        detections.control(ctx, sd, pool)
        return
    torch.set_num_threads(wl["intra_op_threads"])
    handle = YOLO(cfg["model"], nc=cfg["nc"], imgsz=wl["imgsz"], device=dev)
    handle._ensure_built().load_state_dict(sd)
    # every call takes the next ``batch`` images of a seeded order of the pool
    order = traffic.choices(ctx.seed, len(pool) * 64, len(pool))
    pos = 0

    def call():
        nonlocal pos
        srcs = [pool[j] for j in order[pos:pos + batch]]
        idx = order[pos:pos + batch]
        pos = (pos + batch) % (len(order) - batch)
        return idx, handle.predict(srcs, conf=wl["conf"], iou=wl["iou"], batch_size=batch)

    for _ in range(wl["warm_calls"]):
        call()
    if cuda:
        torch.cuda.synchronize(dev)
    k = wl["check_requests"]
    sampler = detections.Sampler(ctx.seed, wl["check_share"], k // 8, len(order))
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    ctx.e2e["setup_s"] = time.perf_counter() - ctx.t_start

    window = min(ctx.seconds, wl["trace_seconds"]) if ctx.trace else ctx.seconds
    prof = T.start() if ctx.trace else None
    returned, calls = 0, 0
    with T.record("window"):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window:
            with T.record("predict"):
                idx, res = call()
            for j, det in zip(idx, res):
                sampler.offer(returned, pool[j], det)
                returned += 1
            calls += 1
        t1 = time.perf_counter()
    if prof is not None:
        if cuda:
            torch.cuda.synchronize(dev)
        prof.stop()
        ctx.tr = T.Trace(prof)
        ctx.breakdown = {"device_ops": ctx.tr.top_ops(), "idle_gaps": ctx.tr.idle_gaps()}
    ctx.e2e["predict_img_s"] = returned / (t1 - t0)
    ctx.attempted = calls * batch
    ctx.failed = calls * batch - returned
    ctx.counters.update(window_s=t1 - t0, window_images=returned, calls=calls,
                        nms_rows=calls * batch)
    if cuda:
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    imgs, served = sampler.picked(k)
    del handle
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    detections.judge(ctx, sd, imgs, served)

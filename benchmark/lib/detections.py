"""Judging served detections (the serving and predict cells): a seeded
sample of the finished requests, the largest images in it, run through
the reference after the program is freed, and the numbers compared."""

from __future__ import annotations

import heapq
import sys
import threading

import numpy as np

from . import compare, traffic


class Sampler:
    """A seeded sample of the answers a run receives, kept as they come so
    that the run holds no other answer: answer ``p`` (its position in the
    stream of requests) is kept when the seed's uniform draw for ``p`` is
    under ``share``, and the ``largest`` answers by image area are kept
    besides. Thread-safe."""

    def __init__(self, seed: int, share: float, largest: int, positions: int):
        self.draw = traffic.rng(seed, 6).random(positions)
        self.share, self.largest = share, largest
        self.kept: dict = {}
        self.big: list = []          # min-heap of (area, position)
        self.lock = threading.Lock()

    def offer(self, pos: int, image: np.ndarray, answer) -> None:
        area = image.shape[0] * image.shape[1]
        with self.lock:
            if pos < len(self.draw) and self.draw[pos] < self.share:
                self.kept[pos] = (image, answer)
            if len(self.big) < self.largest:
                heapq.heappush(self.big, (area, pos, image, answer))
            elif self.big and (area, pos) > self.big[0][:2]:
                heapq.heapreplace(self.big, (area, pos, image, answer))

    def picked(self, k: int):
        """(images, answers): the largest, then the drawn ones, at most k."""
        with self.lock:
            chosen = {pos: (img, ans) for _, pos, img, ans in self.big}
            for pos in sorted(self.kept):
                if len(chosen) >= k:
                    break
                chosen.setdefault(pos, self.kept[pos])
        items = [chosen[p] for p in sorted(chosen)]
        return [img for img, _ in items], [ans for _, ans in items]


def _reference(ctx, sd, precision: str):
    from ..reference import model as ref

    ref.set_precision(precision)
    model = ref.Detector(ctx.cfg).to(ctx.device)
    model.load_state_dict(sd)
    return model.eval()


def candidates(ctx, sd, images, precision: str = "f32"):
    from ..reference import detect, model as ref

    try:
        model = _reference(ctx, sd, precision)
        with ref.f32_exact():
            return detect.candidates(model, images, ctx.wl["imgsz"], ctx.device,
                                     ctx.wl["conf"], ctx.wl["iou"])
    finally:
        ref.set_precision("f32")


def judge(ctx, sd, images, served) -> None:
    """``served``: the program's results (``boxes``, ``scores``,
    ``classes``) for ``images``, in the images' pixels."""
    cands = candidates(ctx, sd, images)
    _check(ctx, [(d.boxes, d.scores, d.classes) for d in served], cands)


def _check(ctx, served, cands) -> None:
    g = compare.detection_gaps(served, [(b, s) for b, s, _ in cands])
    # the class gap is printed, not compared: its sound readings reach a
    # third of the control's (PERF.md); "missed" catches a wrong class
    print(f"detections: class gap {g['class']!r}", file=sys.stderr)
    for name in ("box_px", "score"):
        ctx.check(name, g[name])
    kept = [(b[k], s[k].argmax(-1)) for b, s, k in cands]
    ctx.check("missed", compare.missed(served, kept))
    ctx.counters.update(judged=len(served), judged_detections=sum(len(b) for b, _, _ in served))


def control(ctx, sd, pool) -> None:
    """The reference in fp8 in the program's place, on a seeded sample of
    the pool: its NMS's detections judged like the program's."""
    pick = traffic.choices(ctx.seed, ctx.wl["check_requests"], len(pool))
    images = [pool[i] for i in pick]
    low = candidates(ctx, sd, images, "fp8")
    served = []
    for b, s, keep in low:
        best, cls = s[keep].max(-1)
        served.append((b[keep].cpu().numpy(), best.cpu().numpy(), cls.cpu().numpy()))
    _check(ctx, served, candidates(ctx, sd, images))

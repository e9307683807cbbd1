"""Traffic generators: everything a run feeds the program, made from the
seed and the cell's parameters. The same seed gives the same inputs.

Every seed gets the same *set* of sizes (image shapes, box counts, arrival
gaps), in an order the seed shuffles, with contents drawn from the seed:
so two seeds do the same amount of work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _spread(n: int, lo: float, hi: float) -> np.ndarray:
    """n values evenly spread over [lo, hi] (midpoints)."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def image_shapes(seed: int, n: int, long_lo: int, long_hi: int, aspect_lo: float,
                 aspect_hi: float) -> List[Tuple[int, int]]:
    """n (h, w) shapes: long sides evenly spread over [long_lo, long_hi],
    aspects (w / h) log-evenly over [aspect_lo, aspect_hi], each list
    shuffled by the seed."""
    r = rng(seed, 1)
    longs = r.permutation(np.round(_spread(n, long_lo, long_hi)).astype(int))
    aspects = np.exp(r.permutation(_spread(n, math.log(aspect_lo), math.log(aspect_hi))))
    out = []
    for L, a in zip(longs, aspects):
        h, w = (L, L * a) if a < 1 else (L / a, L)
        out.append((max(int(round(h)), 8), max(int(round(w)), 8)))
    return out


def paint(shape_hw: Tuple[int, int], gen: torch.Generator, device) -> torch.Tensor:
    """An (h, w, 3) uint8 image on ``device``: a smooth field of 16-pixel
    colour cells plus noise of +-20 levels."""
    h, w = shape_hw
    base = torch.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), generator=gen, device=device,
                         dtype=torch.int16)
    img = base.repeat_interleave(16, 0).repeat_interleave(16, 1)[:h, :w]
    noise = torch.randint(-20, 21, (h, w, 3), generator=gen, device=device, dtype=torch.int16)
    return (img + noise).clamp(0, 255).to(torch.uint8)


def image_pool(seed: int, p: Dict, device) -> List[np.ndarray]:
    """The cell's pool of raw RGB uint8 images (host arrays, as callers hold
    them), painted on ``device`` from the seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = image_shapes(seed, p["images"], p["long_side"][0], p["long_side"][1],
                          p["aspect"][0], p["aspect"][1])
    imgs = [paint(s, gen, device) for s in shapes]
    return [im.cpu().numpy() for im in imgs]


def box_counts(seed: int, n: int, lo: int, hi: int, mean: float) -> np.ndarray:
    """n GT counts in [lo, hi] with the given mean: the quantiles of a
    geometric law shifted to ``lo`` (COCO's counts are long-tailed),
    truncated at ``hi``, shuffled by the seed."""
    q = (np.arange(n) + 0.5) / n
    p = 1.0 / (mean - lo + 1.0)
    counts = lo + np.floor(np.log1p(-q) / math.log1p(-p)).astype(int)
    return rng(seed, 2).permutation(np.clip(counts, lo, hi))


def device_cache(seed: int, p: Dict, imgsz: int, max_boxes: int, device):
    """The Trainer's device cache of ``p["images"]`` samples, as its loader
    makes it: (images (N, S, S, 3) u8 keep-ratio resized content at the top
    left and 114 around it, hw (N, 2) f32 content (h, w), boxes (N, M, 4)
    f32 xyxy canvas pixels, classes (N, M) i32, mask (N, M) bool) with M =
    ``max_boxes``. Content shapes: long side S, aspects as ``image_shapes``;
    each box 8-100% of the content's sides (log-even), placed inside it."""
    n = p["images"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shapes = image_shapes(seed, n, imgsz, imgsz, p["aspect"][0], p["aspect"][1])
    hw = torch.tensor(shapes, dtype=torch.float32, device=device)
    base = torch.randint(0, 256, (n, imgsz // 16 + 1, imgsz // 16 + 1, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    images = base.repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :imgsz, :imgsz]
    images = images.contiguous()
    noise = torch.randint(-20, 21, images.shape, generator=gen, device=device, dtype=torch.int8)
    images = (images.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)
    ys = torch.arange(imgsz, device=device)
    outside = (ys[None, :, None] >= hw[:, 0, None, None]) | (ys[None, None, :] >= hw[:, 1, None, None])
    images[outside] = 114
    counts = torch.tensor(box_counts(seed, n, p["boxes"][0], p["boxes"][1], p["boxes_mean"]),
                          device=device)
    u = torch.rand((n, max_boxes, 4), generator=gen, device=device)
    lo, hi = math.log(p["box_side"][0]), math.log(p["box_side"][1])
    side = torch.exp(lo + (hi - lo) * u[..., :2])              # share of (w, h)
    wh = side * hw.flip(-1)[:, None, :]
    xy = u[..., 2:] * (hw.flip(-1)[:, None, :] - wh)
    boxes = torch.cat([xy, xy + wh], -1)
    mask = torch.arange(max_boxes, device=device)[None, :] < counts[:, None]
    classes = torch.randint(0, p["classes"], (n, max_boxes), generator=gen, device=device,
                            dtype=torch.int32)
    return (images, hw, boxes * mask[..., None], classes * mask, mask)


def train_schedule(seed: int, n_images: int, batch: int, steps: int) -> Tuple[np.ndarray, List[int]]:
    """``steps`` batches of dataset indices (steps, batch): epochs of a
    seeded permutation, each cut into whole batches; and each step's
    augmentation seed."""
    r = rng(seed, 3)
    per_epoch = n_images // batch
    rows = []
    while len(rows) < steps:
        perm = r.permutation(n_images)
        rows.extend(perm[i * batch:(i + 1) * batch] for i in range(per_epoch))
    base = (int(seed) % (2 ** 31)) << 20
    return np.stack(rows[:steps]), [base + i for i in range(steps)]


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of a Poisson stream of ``rate`` requests a
    second, conditioned on its count round(rate * seconds): sorted uniform
    draws, so every seed offers exactly as many requests."""
    n = int(round(rate * seconds))
    return np.sort(rng(seed, 4).uniform(0.0, seconds, n))


def choices(seed: int, n: int, pool: int, stream: int = 5) -> np.ndarray:
    """Which pool image each of n requests sends: every image equally often
    (n // pool times, the rest spread), in a seeded order."""
    idx = np.resize(np.arange(pool), n)
    return rng(seed, stream).permutation(idx)

"""Host augmentation: mosaic, random affine, mixup, HSV and flips, in numpy.

Counterpart of ``deal_yolo_daya_tpu/train/augment.py``, which does the
pixel work with cv2; the card machine has no cv2, so here it is numpy. The
random draws are the JAX package's, call for call, from the same
``np.random.Generator``: a sample drawn under one seed gets the same
mosaic centre, partners, scale, translation, angle, shear, gains and flips
in both packages, hence the same boxes and classes.

The pixels are cv2's arithmetic written out, and differ from it only where
the two compute in other precision:

- ``rgb_to_hsv``/``hsv_to_rgb``: cv2's 8-bit RGB<->HSV (H in [0, 180)),
  the way back as cv2's vector loop computes it;
- the LUTs of ``hsv_jitter``: plain indexing, as ``cv2.LUT``;
- ``warp_affine``: ``cv2.warpAffine`` with ``INTER_LINEAR`` and a constant
  border of 114, as OpenCV 5 computes it: the matrix inverted as cv2
  inverts it, source points and tap weights in f32, taps outside the
  source taking the border value (OpenCV 4 quantised the weights to 1/32
  of a pixel, and lands further from this);
- ``resize_keep_ratio``: the port's u8 bilinear resize (``ops/letterbox``),
  which may land a level from cv2's ``INTER_LINEAR``;
- ``rotation_matrix``: ``cv2.getRotationMatrix2D``'s arithmetic.

``tests/test_torch_port_host_augment.py`` states how far each lands from
cv2 (the cv2 of the machine that runs it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from ..ops.letterbox import resize_bilinear

FILL = 114


@dataclass
class AugmentConfig:
    mosaic: float = 1.0
    mixup: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    fliplr: float = 0.5
    flipud: float = 0.0
    bgr: float = 0.0


def resize_keep_ratio(img: np.ndarray, target: int) -> Tuple[np.ndarray, float]:
    """Resize so that the long side is ``target`` -> (image, scale)."""
    h, w = img.shape[:2]
    r = target / max(h, w)
    if r != 1.0:
        img = resize_bilinear(img, round(h * r), round(w * r))
    return img, r


# ---------------------------------------------------------------- colour

_HSV_SHIFT = 12
with np.errstate(divide="ignore"):
    _SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int64)
    _HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]
                           ).astype(np.int64)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """u8 RGB -> u8 HSV with H in [0, 180): cv2's fixed-point COLOR_RGB2HSV."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """u8 HSV (H in [0, 180)) -> u8 RGB: cv2's vectorised COLOR_HSV2RGB, in
    f32: S and V scaled by 1/255, the sector's three values, then each
    channel x 255 truncated (cv2 rounds instead on the few pixels of a row
    its vector loop leaves over)."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1)
    return np.clip(np.floor(bgr[..., ::-1] * f32(255)), 0, 255).astype(np.uint8)


def hsv_jitter(img: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig) -> np.ndarray:
    """Random HSV gain jitter (uint8 in and out)."""
    if cfg.hsv_h == cfg.hsv_s == cfg.hsv_v == 0:
        return img
    gains = rng.uniform(-1, 1, 3) * [cfg.hsv_h, cfg.hsv_s, cfg.hsv_v] + 1
    hsv = rgb_to_hsv(img)
    x = np.arange(256, dtype=np.int16)
    lut_h = ((x * gains[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * gains[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * gains[2], 0, 255).astype(np.uint8)
    out = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], -1)
    return hsv_to_rgb(out)


# ---------------------------------------------------------------- geometry


def rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D about (0, 0): (2, 3) float64."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.warpAffine's inversion of a forward (2, 3) matrix."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return np.array(m)


def warp_affine(img: np.ndarray, m: np.ndarray, out_size: int, fill: int = FILL) -> np.ndarray:
    """u8 (H, W, C) through the forward (2, 3) map ``m`` into (out_size,
    out_size, C): cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT, fill). Each
    output pixel maps back through the inverted matrix to a source point,
    in f32; its four taps are weighted in f32, those outside the source
    read ``fill``, and the sum is rounded to the nearest level (ties to
    even)."""
    h, w, c = img.shape
    f32 = np.float32
    inv = _invert_affine(m).astype(f32)
    ys, xs = np.meshgrid(np.arange(out_size, dtype=f32), np.arange(out_size, dtype=f32),
                         indexing="ij")
    sx = inv[0] * xs + inv[1] * ys + inv[2]
    sy = inv[3] * xs + inv[4] * ys + inv[5]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # a two-pixel ring of fill: points further out clip onto it
    x0 = np.clip(x0, -2, w).astype(np.int64) + 2
    y0 = np.clip(y0, -2, h).astype(np.int64) + 2
    padded = np.full((h + 4, w + 4, c), fill, f32)
    padded[2:h + 2, 2:w + 2] = img
    one = f32(1)
    out = (padded[y0, x0] * (one - fx) * (one - fy) + padded[y0, x0 + 1] * fx * (one - fy)
           + padded[y0 + 1, x0] * (one - fx) * fy + padded[y0 + 1, x0 + 1] * fx * fy)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def random_affine(img: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                  rng: np.random.Generator, cfg: AugmentConfig, out_size: int,
                  border: Tuple[int, int] = (0, 0)):
    """Scale/translate (+ optional rotate/shear) affine with the box
    transform and the degenerate-box filter -> (image, boxes, classes)."""
    h, w = img.shape[:2]
    c = np.eye(3)
    c[0, 2] = -w / 2
    c[1, 2] = -h / 2
    a = rng.uniform(-cfg.degrees, cfg.degrees)
    s = rng.uniform(1 - cfg.scale, 1 + cfg.scale)
    r = np.eye(3)
    r[:2] = rotation_matrix(a, s)
    sh = np.eye(3)
    sh[0, 1] = math.tan(rng.uniform(-cfg.shear, cfg.shear) * math.pi / 180)
    sh[1, 0] = math.tan(rng.uniform(-cfg.shear, cfg.shear) * math.pi / 180)
    t = np.eye(3)
    t[0, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * out_size
    t[1, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * out_size
    m = t @ sh @ r @ c

    img = warp_affine(img, m[:2], out_size)
    if len(boxes) == 0:
        return img, boxes.reshape(0, 4), classes

    n = len(boxes)
    corners = np.ones((n * 4, 3))
    corners[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
    corners = (corners @ m.T)[:, :2].reshape(n, 8)
    xs, ys = corners[:, [0, 2, 4, 6]], corners[:, [1, 3, 5, 7]]
    new_boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    new_boxes[:, [0, 2]] = new_boxes[:, [0, 2]].clip(0, out_size)
    new_boxes[:, [1, 3]] = new_boxes[:, [1, 3]].clip(0, out_size)

    # filter: at least 2 px a side, 10% of the scaled area kept, aspect < 100
    bw = new_boxes[:, 2] - new_boxes[:, 0]
    bh = new_boxes[:, 3] - new_boxes[:, 1]
    old_area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) * (s ** 2)
    keep = ((bw > 2) & (bh > 2) & (bw * bh / (old_area + 1e-16) > 0.1)
            & (np.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16)) < 100))
    return img, new_boxes[keep], classes[keep]


def mosaic4(images: Sequence[np.ndarray], boxes_list: Sequence[np.ndarray],
            classes_list: Sequence[np.ndarray], imgsz: int, rng: np.random.Generator,
            cfg: AugmentConfig):
    """The 4-image mosaic: a 2x canvas, a random centre, then the affine
    crop back to imgsz x imgsz -> (image, boxes, classes)."""
    s = imgsz
    canvas = np.full((2 * s, 2 * s, 3), FILL, dtype=np.uint8)
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    all_boxes, all_classes = [], []
    for i in range(4):
        img, r = resize_keep_ratio(images[i], s)
        h, w = img.shape[:2]
        if i == 0:    # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:         # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        if len(boxes_list[i]):
            b = boxes_list[i] * r + [x1a - x1b, y1a - y1b, x1a - x1b, y1a - y1b]
            all_boxes.append(b)
            all_classes.append(classes_list[i])
    boxes = np.concatenate(all_boxes, 0) if all_boxes else np.zeros((0, 4), np.float32)
    classes = np.concatenate(all_classes, 0) if all_classes else np.zeros((0,), np.int64)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    return random_affine(canvas, boxes, classes, rng, cfg, out_size=imgsz,
                         border=(-s // 2, -s // 2))


def mixup(img1: np.ndarray, boxes1: np.ndarray, cls1: np.ndarray, img2: np.ndarray,
          boxes2: np.ndarray, cls2: np.ndarray, rng: np.random.Generator):
    """Blend two samples with a Beta(32, 32) weight; labels are unioned."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    boxes = np.concatenate([boxes1, boxes2], 0) if len(boxes1) or len(boxes2) else boxes1
    classes = np.concatenate([cls1, cls2], 0) if len(cls1) or len(cls2) else cls1
    return img, boxes, classes


def flips(img: np.ndarray, boxes: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig):
    """Left-right and up-down flips and the channel swap -> (image, boxes)."""
    h, w = img.shape[:2]
    if cfg.fliplr > 0 and rng.random() < cfg.fliplr:
        img = np.ascontiguousarray(img[:, ::-1])
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    if cfg.flipud > 0 and rng.random() < cfg.flipud:
        img = np.ascontiguousarray(img[::-1])
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    if cfg.bgr > 0 and rng.random() < cfg.bgr:  # channel swap; boxes unchanged
        img = np.ascontiguousarray(img[..., ::-1])
    return img, boxes

"""Synthetic detection dataset in the YOLO layout, without cv2: the shapes
dataset of ``tools/synth_dataset.py`` (circles, squares and triangles on a
blurred noise background), for machines that have numpy but no cv2.

It draws the same ``np.random.default_rng(seed)`` stream in the same order
as ``tools/synth_dataset.py``, so the labels are identical. The pixels are
its own: shapes rasterised in numpy (a pixel is inside a circle when its
centre is within the radius, inside the triangle when it lies on the inner
side of the three edges, and the square is cv2's, corners included), the
background blurred by cv2's 5x5 Gaussian ([1, 4, 6, 4, 1] / 16 each way,
reflected border, rounded half up from the exact sum), and the images are
written as PNG by the port's own writer (``ops/png.py``) where the cv2 tool
writes JPEG.

Usage: python tools/synth_dataset_torch.py --out DIR --train 600 --val 100 --imgsz 320
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import yaml

NAMES = ["circle", "square", "triangle"]
COLORS = [(220, 60, 60), (60, 200, 80), (70, 90, 230)]
_TAPS = np.array([1, 4, 6, 4, 1], np.int64)


def blur5(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (5, 5), 0) on u8: the separable [1, 4, 6, 4, 1]
    kernel with BORDER_REFLECT_101, the sum over 256 rounded half up."""
    h, w = img.shape[:2]
    ys = np.abs(np.arange(-2, h + 2))
    ys = np.where(ys >= h, 2 * (h - 1) - ys, ys)
    xs = np.abs(np.arange(-2, w + 2))
    xs = np.where(xs >= w, 2 * (w - 1) - xs, xs)
    src = img.astype(np.int64)[ys][:, xs]
    rows = sum(t * src[:, i:i + w] for i, t in enumerate(_TAPS))
    out = sum(t * rows[i:i + h] for i, t in enumerate(_TAPS))
    return ((out + 128) >> 8).astype(np.uint8)


def draw_shape(img: np.ndarray, cls: int, cx: int, cy: int, r: int, rng) -> tuple:
    """Fill one shape of class ``cls`` centred at (cx, cy) with half-size r
    in a colour drawn as the cv2 tool draws it -> its box."""
    color = np.array([int(c + rng.integers(-25, 25)) for c in COLORS[cls]], np.uint8)
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(cy - r, 0), min(cy + r, h - 1), max(cx - r, 0), min(cx + r, w - 1)
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    if cls == 0:
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    elif cls == 1:
        inside = np.ones_like(xx, bool)
    else:  # apex (cx, cy - r), base corners (cx -+ r, cy + r)
        inside = (2 * np.abs(xx - cx) <= yy - (cy - r)) & (yy <= cy + r)
    img[y0:y1 + 1, x0:x1 + 1][inside] = color
    return cx - r, cy - r, cx + r, cy + r


def make_image(imgsz: int, rng) -> tuple:
    base = rng.integers(30, 120, 3)
    img = np.full((imgsz, imgsz, 3), base, np.uint8)
    noise = rng.normal(0, 18, (imgsz, imgsz, 3))
    img = np.clip(img.astype(np.int16) + noise.astype(np.int16), 0, 255).astype(np.uint8)
    img = blur5(img)

    boxes, classes, occupied = [], [], []
    for _ in range(int(rng.integers(1, 5))):
        cls = int(rng.integers(0, 3))
        r = int(rng.integers(imgsz // 14, imgsz // 5))
        cx = int(rng.integers(r + 2, imgsz - r - 2))
        cy = int(rng.integers(r + 2, imgsz - r - 2))
        # reject heavy overlap with the objects already placed
        if not all(max(0, min(cx + r, x2) - max(cx - r, x1))
                   * max(0, min(cy + r, y2) - max(cy - r, y1)) < 0.3 * (2 * r) ** 2
                   for x1, y1, x2, y2 in occupied):
            continue
        box = draw_shape(img, cls, cx, cy, r, rng)
        occupied.append(box)
        boxes.append(box)
        classes.append(cls)
    return img, boxes, classes


def generate(out: Path, n_train: int, n_val: int, imgsz: int, seed: int = 0) -> Path:
    """Write the dataset under ``out`` -> its data.yaml."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from deal_yolo_daya_tpu_torch.ops.png import write_png

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (out / "images" / split).mkdir(parents=True, exist_ok=True)
        (out / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, boxes, classes = make_image(imgsz, rng)
            write_png(out / "images" / split / f"{i:05d}.png", img)
            lines = [f"{c} {(x1 + x2) / 2 / imgsz:.6f} {(y1 + y2) / 2 / imgsz:.6f} "
                     f"{(x2 - x1) / imgsz:.6f} {(y2 - y1) / imgsz:.6f}"
                     for (x1, y1, x2, y2), c in zip(boxes, classes)]
            (out / "labels" / split / f"{i:05d}.txt").write_text("\n".join(lines))
    data_yaml = out / "data.yaml"
    data_yaml.write_text(yaml.dump({"path": str(out), "train": "images/train",
                                    "val": "images/val", "nc": len(NAMES), "names": NAMES},
                                   sort_keys=False))
    return data_yaml


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=600)
    ap.add_argument("--val", type=int, default=100)
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(generate(Path(args.out), args.train, args.val, args.imgsz, args.seed))

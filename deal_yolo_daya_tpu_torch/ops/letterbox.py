"""Letterbox resize: aspect-preserving scale, then pad to a square canvas.

Counterpart of ``letterbox_params`` and ``letterbox_numpy`` in
``deal_yolo_daya_tpu/ops/letterbox.py``. The JAX package resizes with cv2
(``INTER_LINEAR``) or PIL; here the resize is PyTorch's uint8 bilinear
interpolation (half-pixel centres, no antialias, the mapping cv2 uses), so no
image library is needed. Both round in fixed point, each its own way, so the
two canvases differ by a level of 255 at some pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def letterbox_params(h: int, w: int, new_size: int) -> Tuple[float, int, int]:
    """(scale, pad_x, pad_y) for an h x w image into new_size x new_size,
    centre-padded (ultralytics-compatible rounding)."""
    r = min(new_size / h, new_size / w)
    new_unpad = (round(w * r), round(h * r))
    dw = (new_size - new_unpad[0]) / 2
    dh = (new_size - new_unpad[1]) / 2
    return r, int(round(dw - 0.1)), int(round(dh - 0.1))


def letterbox_numpy(image: np.ndarray, new_size: int, fill: int = 114
                    ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """One (H, W, C) uint8 image -> (canvas (new_size, new_size, C) uint8,
    scale, (pad_x, pad_y))."""
    h, w = image.shape[:2]
    r, px, py = letterbox_params(h, w, new_size)
    nw, nh = round(w * r), round(h * r)
    canvas = np.full((new_size, new_size, image.shape[2]), fill, dtype=image.dtype)
    if (nh, nw) == (h, w):
        canvas[py:py + nh, px:px + nw] = image
        return canvas, r, (px, py)
    # (1, C, H, W) view of the HWC array: channels_last strides, which with
    # uint8 in and out takes PyTorch's vectorised fixed-point bilinear path
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    resized = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                            antialias=False)[0].permute(1, 2, 0)
    canvas[py:py + nh, px:px + nw] = resized.numpy()
    return canvas, r, (px, py)


def load_image(path) -> np.ndarray:
    """Decode an image file to RGB uint8 (cv2 if installed, else PIL)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))

"""Letterbox resize: aspect-preserving scale, then pad to a square canvas.

Counterpart of ``letterbox_params``, ``letterbox_batch`` and
``letterbox_numpy`` in ``deal_yolo_daya_tpu/ops/letterbox.py``. The JAX
package resizes one image with cv2 (``INTER_LINEAR``) or PIL; here the
resize is PyTorch's uint8 bilinear interpolation (half-pixel centres, no
antialias, the mapping cv2 uses), so no image library is needed. Both round
in fixed point, each its own way, so the two canvases differ by a level of
255 at some pixels. ``letterbox_batch`` is the JAX package's batched f32
resample by inverse-mapping gathers, in plain PyTorch on the input's device.
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


def letterbox_batch(images: torch.Tensor, scales, pads, out_size: int, fill: float = 114.0,
                    bilinear: bool = True) -> torch.Tensor:
    """Batch letterbox by inverse-mapping gathers.

    images: (B, H, W, C) source batch of one shape, float32 or uint8.
    scales: (B,) per-image scale factors r.
    pads:   (B, 2) per-image (pad_x, pad_y) offsets in output pixels.
    Returns (B, out_size, out_size, C) float32: an output pixel maps to the
    source point ((x - pad_x + 0.5) / r - 0.5, likewise y), sampled
    bilinearly (each neighbour clipped from the unclipped floor, so points
    past the border replicate it) or at the nearest pixel (ties to even);
    pixels whose point lies outside the image's half-pixel border get
    ``fill``."""
    b, h, w, c = images.shape
    x = images.float().reshape(b, h * w, c)
    dev = x.device
    scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    pads = torch.as_tensor(pads, dtype=torch.float32, device=dev)
    grid = torch.arange(out_size, dtype=torch.float32, device=dev)
    r = scales[:, None, None]
    src_x = (grid[None, None, :] - pads[:, 0, None, None] + 0.5) / r - 0.5  # (B, 1, S)
    src_y = (grid[None, :, None] - pads[:, 1, None, None] + 0.5) / r - 0.5  # (B, S, 1)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return x.gather(1, idx).reshape(b, out_size, out_size, c)

    if bilinear:
        x0, y0 = torch.floor(src_x), torch.floor(src_y)
        fx, fy = (src_x - x0)[..., None], (src_y - y0)[..., None]
        x0i, y0i = x0.long(), y0.long()
        x0c, x1c = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
        y0c, y1c = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)
        out = (gather(y0c, x0c) * (1 - fx) * (1 - fy)
               + gather(y0c, x1c) * fx * (1 - fy)
               + gather(y1c, x0c) * (1 - fx) * fy
               + gather(y1c, x1c) * fx * fy)
    else:
        xi = torch.round(src_x).long().clamp(0, w - 1)
        yi = torch.round(src_y).long().clamp(0, h - 1)
        out = gather(yi, xi)
    valid = (src_x >= -0.5) & (src_x <= w - 0.5) & (src_y >= -0.5) & (src_y <= h - 0.5)
    return torch.where(valid[..., None], out, float(fill))


def letterbox_numpy(image: np.ndarray, new_size: int, fill: int = 114
                    ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """One (H, W, C) uint8 image -> (canvas (new_size, new_size, C) uint8,
    scale, (pad_x, pad_y))."""
    h, w = image.shape[:2]
    r, px, py = letterbox_params(h, w, new_size)
    nw, nh = round(w * r), round(h * r)
    canvas = np.full((new_size, new_size, image.shape[2]), fill, dtype=image.dtype)
    canvas[py:py + nh, px:px + nw] = resize_bilinear(image, nh, nw)
    return canvas, r, (px, py)


def resize_bilinear(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, bilinear with half-pixel centres
    and no antialias (cv2's INTER_LINEAR mapping); the image itself when the
    size is unchanged."""
    if image.shape[:2] == (h, w):
        return image
    # (1, C, H, W) view of the HWC array: channels_last strides, which with
    # uint8 in and out takes PyTorch's vectorised fixed-point bilinear path
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    resized = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                            antialias=False)[0].permute(1, 2, 0)
    return resized.numpy()


def load_image(path) -> np.ndarray:
    """Decode an image file to RGB uint8: cv2 if installed, else PIL, else
    the port's own PNG reader (``ops/png.py``)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        from .png import read_png

        return read_png(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))

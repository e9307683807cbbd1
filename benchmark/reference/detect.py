"""The reference of the inference path: letterbox, forward, decode, and
the per-anchor candidates in original-image pixels that a served detection
is judged against. Plain PyTorch, float32 (or the control's fp8 products).

A detection the program serves is (box, score, class) of one anchor that
survived NMS: its class the anchor's best class, its score that class's
sigmoid. The reference computes every anchor's box and class scores and
the count that greedy NMS keeps; the judge (``lib/compare.py``) finds, for
each served detection, the anchor that explains it best.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import decode

FILL = 114


def letterbox_geometry(h: int, w: int, size: int) -> Tuple[float, int, int, int, int]:
    """(scale, new_w, new_h, pad_x, pad_y): the image scaled by
    min(size / h, size / w), rounded to whole pixels, centred with the odd
    pixel on the right and bottom (ultralytics' ``LetterBox`` rounding)."""
    r = min(size / h, size / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    px, py = int(round((size - nw) / 2 - 0.1)), int(round((size - nh) / 2 - 0.1))
    return r, nw, nh, px, py


def letterbox(image: np.ndarray, size: int, device) -> Tuple[torch.Tensor, float, int, int]:
    """(H, W, 3) uint8 -> ((size, size, 3) float32 canvas on ``device``, r,
    pad_x, pad_y): bilinear resize with half-pixel centres (computed in
    float32, rounded to the nearest level), fill 114 around."""
    h, w = image.shape[:2]
    r, nw, nh, px, py = letterbox_geometry(h, w, size)
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).permute(2, 0, 1)[None].float()
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=False).round().clamp(0, 255)
    canvas = torch.full((3, size, size), float(FILL), device=device)
    canvas[:, py:py + nh, px:px + nw] = x[0]
    return canvas.permute(1, 2, 0), r, px, py


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, conf: float, iou: float,
             pre_topk: int = 1000, max_det: int = 300) -> torch.Tensor:
    """The anchors greedy class-aware NMS keeps for one image, best first:
    of the anchors whose best score reaches ``conf``, the ``pre_topk`` best
    (ties in anchor order), each kept unless a kept one of its class
    overlaps it by IoU over ``iou``; at most ``max_det``."""
    best, cls = scores.max(-1)
    ok = torch.nonzero(best >= conf).flatten()
    order = ok[torch.sort(best[ok], descending=True, stable=True).indices][:pre_topk]
    b, c = boxes[order], cls[order]
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = (b[:, 2:] - b[:, :2]).clamp(min=0).prod(-1)
    over = inter / (area[:, None] + area[None, :] - inter + 1e-7) > iou
    over = (over & (c[:, None] == c[None, :])).cpu().numpy()
    suppressed = np.zeros(len(order), bool)
    kept = []
    for i in range(len(order)):
        if suppressed[i]:
            continue
        kept.append(i)
        if len(kept) == max_det:
            break
        suppressed |= over[i]
    return order[torch.as_tensor(kept, dtype=torch.long, device=order.device)]


@torch.no_grad()
def candidates(model, images: Sequence[np.ndarray], size: int, device, conf: float, iou: float,
               chunk: int = 32) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """For each image, every anchor's box (xyxy in the image's own pixels,
    clipped to it, (A, 4)) and class scores (A, nc), and the anchors greedy
    NMS keeps, computed in chunks of ``chunk`` images by ``model`` (the
    reference, in eval mode)."""
    out = []
    for s in range(0, len(images), chunk):
        part = images[s:s + chunk]
        lb = [letterbox(img, size, device) for img in part]
        x = torch.stack([c for c, *_ in lb]).permute(0, 3, 1, 2) / 255.0
        box, cls = model(x)
        xyxy, scores = decode(box, cls, size)
        for i, (img, (_, r, px, py)) in enumerate(zip(part, lb)):
            keep = nms_keep(xyxy[i], scores[i], conf, iou)
            b = (xyxy[i] - torch.tensor([px, py, px, py], device=device)) / r
            h, w = img.shape[:2]
            b = torch.stack([b[:, 0].clamp(0, w), b[:, 1].clamp(0, h), b[:, 2].clamp(0, w),
                             b[:, 3].clamp(0, h)], -1)
            out.append((b, scores[i], keep))
    return out

"""Vectorized box math for the annotation pipeline.

The reference's IoU quality filter runs an O(rows x boxes^2) pure-Python loop
(reference: core/processor.py:368-376). Here rows are packed into padded
fixed-shape arrays (rows, MAX_BOXES, 4) + validity mask and the pairwise-IoU
"hit" decision is a few batched PyTorch ops over a chunk of rows, so
million-row tables stream through the card's memory.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def pack_boxes(
    box_lists: Sequence[Sequence[Tuple[float, float, float, float]]],
    max_boxes: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack ragged per-row box lists into (N, M, 4) float32 + (N, M) bool mask."""
    n = len(box_lists)
    if max_boxes is None:
        max_boxes = max((len(b) for b in box_lists), default=0)
    max_boxes = max(max_boxes, 1)
    boxes = np.zeros((n, max_boxes, 4), dtype=np.float32)
    mask = np.zeros((n, max_boxes), dtype=bool)
    for i, row in enumerate(box_lists):
        m = min(len(row), max_boxes)
        if m:
            boxes[i, :m] = np.asarray(row[:m], dtype=np.float32)
            mask[i, :m] = True
    return boxes, mask


def pairwise_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) xyxy -> (..., M, M) IoU with the reference's exact edge
    semantics: zero intersection -> 0, zero union -> 0. Each product, sum
    and the division is its own correctly rounded f32 op, as in the numpy
    path, so both give the same bits."""
    a = boxes[..., :, None, :]
    b = boxes[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    union = area[..., :, None] + area[..., None, :] - inter
    safe_union = torch.where(union != 0, union, torch.ones_like(union))
    return torch.where((inter > 0) & (union != 0), inter / safe_union,
                       torch.zeros_like(inter))


def _hits_batch(boxes: torch.Tensor, mask: torch.Tensor, min_boxes: int,
                thr: torch.Tensor) -> torch.Tensor:
    """(R,) flags of a chunk of (R, M, 4) boxes and (R, M) masks, on their
    device: True where a row has >= min_boxes valid boxes and any distinct
    valid pair with IoU >= thr. ``thr`` is a 0-dim f32 tensor, so the
    comparison is made in f32."""
    m = boxes.shape[-2]
    iou = pairwise_iou_matrix(boxes)
    eye = torch.eye(m, dtype=torch.bool, device=boxes.device)
    pair_mask = mask[..., :, None] & mask[..., None, :] & ~eye
    any_high = (pair_mask & (iou >= thr)).flatten(-2).any(-1)
    return (mask.sum(-1) >= min_boxes) & any_high


def _high_iou_hits_numpy(
    boxes: np.ndarray, mask: np.ndarray, min_boxes: int, thr: float, chunk: int = 4096
) -> np.ndarray:
    """Vectorized host implementation (same semantics as the device path)."""
    n, m, _ = boxes.shape
    out = np.zeros((n,), bool)
    eye = np.eye(m, dtype=bool)
    for s in range(0, n, chunk):
        b = boxes[s : s + chunk]
        mk = mask[s : s + chunk]
        x1 = np.maximum(b[:, :, None, 0], b[:, None, :, 0])
        y1 = np.maximum(b[:, :, None, 1], b[:, None, :, 1])
        x2 = np.minimum(b[:, :, None, 2], b[:, None, :, 2])
        y2 = np.minimum(b[:, :, None, 3], b[:, None, :, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area = (b[:, :, 2] - b[:, :, 0]) * (b[:, :, 3] - b[:, :, 1])
        union = area[:, :, None] + area[:, None, :] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where((inter > 0) & (union != 0), inter / np.where(union != 0, union, 1), 0.0)
        pair = mk[:, :, None] & mk[:, None, :] & ~eye
        hit = (mk.sum(1) >= min_boxes) & np.any(pair & (iou >= thr), axis=(1, 2))
        out[s : s + len(b)] = hit
    return out


# The row count from which the filter takes the device path. It keeps the
# JAX package's name, environment variable and default, so a user's setting
# carries over: the vectorized numpy path does 40k rows in 0.02 s
# on the host, so host numpy is the default at every size; the device path
# is there for huge packed tables.
JAX_MIN_ROWS = int(os.environ.get("DYD_IOU_JAX_MIN_ROWS", 10**9))


def high_iou_hits(
    boxes: np.ndarray,
    mask: np.ndarray,
    min_boxes: int = 2,
    iou_threshold: float = 0.98,
    chunk: int = 8192,
    device=None,
) -> np.ndarray:
    """Per-row hit flags for the IoU quality filter.

    Tables of at least ``JAX_MIN_ROWS`` rows go to ``device`` (the card by
    default: it raises when there is none, unless ``device="cpu"``) in one
    copy and are decided there ``chunk`` rows at a time; smaller tables take
    the vectorized numpy path. Both give the same flags.
    """
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=bool)
    if n < JAX_MIN_ROWS:
        return _high_iou_hits_numpy(boxes, mask, min_boxes, iou_threshold)
    dev = resolve_device(device)
    b = torch.from_numpy(np.ascontiguousarray(boxes, dtype=np.float32)).to(dev)
    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(dev)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        out[start:end] = _hits_batch(b[start:end], m[start:end], min_boxes, thr)
    return out.cpu().numpy()

"""Box geometry: IoU, coordinate transforms and anchors, on torch tensors.

Counterpart of ``deal_yolo_daya_tpu/ops/boxes.py``; the same formulas in the
same operation order, so f32 results agree with the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    lt, rb = x[..., :2], x[..., 2:4]
    return torch.cat([(lt + rb) / 2, rb - lt], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of xyxy boxes (broadcasting)."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (area1 + area2 - inter + eps)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    return bbox_iou(a[:, None, :], b[None, :, :], eps)


def make_anchors(imgsz: Tuple[int, int], strides: Sequence[int] = (8, 16, 32),
                 offset: float = 0.5, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres in grid units, row-major per level, and each anchor's
    stride: (A, 2) and (A, 1)."""
    h, w = imgsz
    points, stride_arr = [], []
    for s in strides:
        fh, fw = h // s, w // s
        ys = torch.arange(fh, dtype=torch.float32, device=device) + offset
        xs = torch.arange(fw, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        stride_arr.append(torch.full((fh * fw, 1), float(s), device=device))
    return torch.cat(points), torch.cat(stride_arr)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = False) -> torch.Tensor:
    """(l,t,r,b) distances from anchor centres -> boxes (grid units)."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)

"""Box geometry: IoU, coordinate transforms and anchors, on torch tensors.

Counterpart of ``deal_yolo_daya_tpu/ops/boxes.py``; the same formulas in the
same operation order, so f32 results agree with the JAX package.
"""

from __future__ import annotations

import math
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


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU (elementwise, broadcasting): IoU - centre-dist/diag - alpha*v.

    The aspect term runs in f32 whatever the input dtype (in bf16 its alpha
    denominator v - iou + 1 underflows near perfect overlap), and alpha is a
    constant trade-off coefficient: no gradient flows through it."""
    iou = bbox_iou(box1, box2, eps)
    cw = torch.maximum(box1[..., 2], box2[..., 2]) - torch.minimum(box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) - torch.minimum(box1[..., 1], box2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    b1c = (box1[..., :2] + box1[..., 2:4]) / 2
    b2c = (box2[..., :2] + box2[..., 2:4]) / 2
    d = (b2c - b1c) ** 2
    rho2 = d[..., 0] + d[..., 1]
    f32 = torch.float32
    w1 = (box1[..., 2] - box1[..., 0]).to(f32)
    h1 = (box1[..., 3] - box1[..., 1]).to(f32)
    w2 = (box2[..., 2] - box2[..., 0]).to(f32)
    h2 = (box2[..., 3] - box2[..., 1]).to(f32)
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / torch.clamp(v - iou.to(f32) + (1 + eps), min=eps)
    return iou - (rho2 / c2 + (alpha * v).to(iou.dtype))


def bbox2dist(bbox: torch.Tensor, anchor_points: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy (grid units) -> (l, t, r, b) distances clamped to [0, reg_max - 1.01]
    for the DFL targets."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:4]
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return dist.clamp(0, reg_max - 1 - 0.01)


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

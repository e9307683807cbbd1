"""Head-output decoding: DFL expectation and anchor decode to pixel boxes.

Counterpart of ``deal_yolo_daya_tpu/ops/decode.py``. The head's per-level
maps are NCHW here; they are flattened to (B, H*W, C) in the row-major anchor
order that JAX's NHWC ``reshape(b, -1, C)`` gives.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .boxes import dist2bbox, make_anchors

REG_MAX = 16


def dfl_expectation(box_dist: torch.Tensor) -> torch.Tensor:
    """(..., 4*REG_MAX) logits -> (..., 4) expected l,t,r,b distances."""
    logits = box_dist.reshape(*box_dist.shape[:-1], 4, REG_MAX)
    probs = torch.softmax(logits.float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=box_dist.device)
    return (probs * bins).sum(-1)


def flatten_levels(box_levels: Sequence[torch.Tensor], cls_levels: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level NCHW maps -> (B, A, 4*REG_MAX), (B, A, nc)."""
    box = torch.cat([x.flatten(2).transpose(1, 2) for x in box_levels], dim=1)
    cls = torch.cat([x.flatten(2).transpose(1, 2) for x in cls_levels], dim=1)
    return box, cls


def decode_predictions(box_levels: Sequence[torch.Tensor], cls_levels: Sequence[torch.Tensor],
                       imgsz: Tuple[int, int], strides: Sequence[int] = (8, 16, 32)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head outputs -> (boxes xyxy pixels (B,A,4), sigmoid scores (B,A,nc))."""
    box, cls = flatten_levels(box_levels, cls_levels)
    anchor_points, stride_per = make_anchors(imgsz, strides, device=box.device)
    dist = dfl_expectation(box)
    boxes = dist2bbox(dist, anchor_points[None]) * stride_per[None]
    return boxes, torch.sigmoid(cls.float())

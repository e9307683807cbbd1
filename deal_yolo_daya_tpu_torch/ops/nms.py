"""Batched fixed-shape NMS.

Counterpart of ``deal_yolo_daya_tpu/ops/nms.py::batched_nms``: exact greedy
NMS, class-aware through a per-class coordinate offset, with outputs padded to
``max_det`` and a per-image detection count. Candidates are ordered with a
stable descending sort, so score ties keep anchor order as ``jax.lax.top_k``
does (``torch.topk`` does not promise that). The suppression solve is
``ops/kernels/nms_suppress.py``: the CUDA kernel on the card, its plain
version on the CPU. The thresholds are Python floats (rounded to f32, as
the JAX package's f32 scalars) or 0-dim f32 tensors on the boxes' device,
compared as they are: an exported program takes them as runtime inputs
(JAX's traced scalars) and nothing here reads them on the host.

``v10_select`` is YOLOv10's selection in place of NMS (no JAX counterpart).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .kernels.nms_suppress import nms_suppress

MAX_WH = 7680.0


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along N by idx (B, M)."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                conf_thres: Union[float, torch.Tensor] = 0.25,
                iou_thres: Union[float, torch.Tensor] = 0.7, pre_topk: int = 1000,
                max_det: int = 300,
                class_agnostic: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxes (B, A, 4) xyxy pixels, scores (B, A, nc) sigmoid scores ->
    (boxes (B,max_det,4), scores (B,max_det), classes (B,max_det) int32,
    n_det (B,) int32)."""
    boxes, scores = boxes.float(), scores.float()
    b, a, _ = boxes.shape
    k = min(pre_topk, a)
    conf = conf_thres if isinstance(conf_thres, torch.Tensor) \
        else float(np.float32(conf_thres))  # compared as the f32 JAX scalar is

    best_score = scores.amax(-1)
    best_cls = scores.argmax(-1)  # first index on ties, as jnp.argmax
    masked = torch.where(best_score >= conf, best_score, -1.0)
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :k]
    cand_scores = masked.gather(1, order)
    cand_boxes = _take(boxes, order)
    cand_cls = best_cls.gather(1, order)
    cand_valid = cand_scores > 0

    offset_boxes = cand_boxes
    if not class_agnostic:
        offset_boxes = cand_boxes + cand_cls[..., None].float() * MAX_WH
    keep = nms_suppress(offset_boxes.contiguous(), cand_valid.contiguous(), iou_thres)

    # kept candidates are already in score order; take the first max_det
    kept_scores = torch.where(keep, cand_scores, -1.0)
    take = min(max_det, k)
    sel = torch.sort(kept_scores, dim=1, descending=True, stable=True).indices[:, :take]
    out_scores = kept_scores.gather(1, sel)
    ok = out_scores > 0
    out_boxes = torch.where(ok[..., None], _take(cand_boxes, sel), 0.0)
    out_cls = torch.where(ok, cand_cls.gather(1, sel), -1).to(torch.int32)
    out_scores = torch.where(ok, out_scores, 0.0)
    if take < max_det:  # fewer candidates than the requested detections
        pad = max_det - take
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((b, pad, 4))], 1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((b, pad))], 1)
        out_cls = torch.cat([out_cls, out_cls.new_full((b, pad), -1)], 1)
    n_det = ok.sum(1, dtype=torch.int32)
    return out_boxes, out_scores, out_cls, n_det


def v10_select(boxes: torch.Tensor, scores: torch.Tensor, max_det: int = 300,
               conf_thres: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """YOLOv10's NMS-free selection (ultralytics' ``v10Detect.postprocess``)
    on the one-to-one head's decoded outputs, then the confidence threshold:
    the ``k = min(max_det, A)`` anchors of the highest class score, then the
    k highest (anchor, class) scores among them; a detection is kept when its
    score exceeds ``conf_thres`` (ultralytics' ``>``), and the kept ones lead
    in score order. boxes (B, A, 4), scores (B, A, nc) -> ``batched_nms``'s
    outputs: (boxes (B,max_det,4), scores (B,max_det), classes (B,max_det)
    int32, n_det (B,) int32), padded with zeros and class -1."""
    boxes, scores = boxes.float(), scores.float()
    b, a, nc = scores.shape
    k = min(max_det, a)
    top = scores.amax(-1).topk(k, dim=1).indices                     # (B, k) anchors
    cand_boxes, cand_scores = _take(boxes, top), _take(scores, top)
    out_scores, flat = cand_scores.flatten(1).topk(k, dim=1)         # (B, k) pairs
    ok = out_scores > (conf_thres if isinstance(conf_thres, torch.Tensor)
                       else float(np.float32(conf_thres)))
    out_boxes = torch.where(ok[..., None], _take(cand_boxes, flat // nc), 0.0)
    out_cls = torch.where(ok, flat % nc, -1).to(torch.int32)
    out_scores = torch.where(ok, out_scores, 0.0)
    if k < max_det:  # fewer anchors than the requested detections
        pad = max_det - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((b, pad, 4))], 1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((b, pad))], 1)
        out_cls = torch.cat([out_cls, out_cls.new_full((b, pad), -1)], 1)
    return out_boxes, out_scores, out_cls, ok.sum(1, dtype=torch.int32)

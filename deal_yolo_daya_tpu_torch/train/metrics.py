"""Detection metrics: precision, recall, mAP50 and mAP50-95 with the
101-point interpolated AP of the ultralytics validator.

The port's copy of ``deal_yolo_daya_tpu/train/metrics.py``: host numpy. The
JAX package matches predictions to GT with a native (C++) matcher when it is
built; the port runs the numpy greedy loop, which that matcher is pinned
bit-identical to.

Matching per image: predictions sorted by confidence; for each IoU
threshold t in 0.50:0.95:0.05 a prediction is a true positive when it
overlaps an unmatched GT of its class with IoU >= t, pairs taken greedily by
IoU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def match_predictions(pred_boxes: np.ndarray, pred_cls: np.ndarray,
                      gt_boxes: np.ndarray, gt_cls: np.ndarray) -> np.ndarray:
    """(n_pred, 10) bool true-positive matrix over the 10 IoU thresholds."""
    n_pred = len(pred_boxes)
    correct = np.zeros((n_pred, len(IOU_THRESHOLDS)), bool)
    if n_pred == 0 or len(gt_boxes) == 0:
        return correct
    iou = iou_matrix(gt_boxes, pred_boxes)  # (n_gt, n_pred)
    iou = iou * (gt_cls[:, None] == pred_cls[None, :])
    for ti, t in enumerate(IOU_THRESHOLDS):
        gi, pi = np.nonzero(iou >= t)
        if len(gi) == 0:
            continue
        # stable descending: IoU ties go to the higher-confidence (earlier)
        # prediction, since predictions arrive sorted by confidence
        order = np.argsort(-iou[gi, pi], kind="stable")
        seen_gt, seen_pred = set(), set()
        for k in order:
            g, p = gi[k], pi[k]
            if g in seen_gt or p in seen_pred:
                continue
            seen_gt.add(g)
            seen_pred.add(p)
            correct[p, ti] = True
    return correct


def _ap_envelope(recall: np.ndarray, precision: np.ndarray):
    """Sentinel-padded recall axis and the monotone precision envelope."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    return mrec, mpre


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (the ultralytics 'interp' method)."""
    mrec, mpre = _ap_envelope(recall, precision)
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


@dataclass
class DetMetrics:
    """Accumulates images, then computes P, R, mAP50, mAP50-95 and curves."""

    nc: int
    tps: List[np.ndarray] = field(default_factory=list)
    confs: List[np.ndarray] = field(default_factory=list)
    pred_classes: List[np.ndarray] = field(default_factory=list)
    gt_classes: List[np.ndarray] = field(default_factory=list)

    def update(self, pred_boxes: np.ndarray, pred_scores: np.ndarray, pred_cls: np.ndarray,
               gt_boxes: np.ndarray, gt_cls: np.ndarray):
        order = pred_scores.argsort()[::-1]
        pred_boxes, pred_scores, pred_cls = pred_boxes[order], pred_scores[order], pred_cls[order]
        self.tps.append(match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls))
        self.confs.append(pred_scores)
        self.pred_classes.append(pred_cls)
        self.gt_classes.append(gt_cls)

    def compute(self) -> Dict[str, float]:
        if not self.tps:
            return {"precision": 0.0, "recall": 0.0, "map50": 0.0, "map": 0.0}
        tp = np.concatenate(self.tps)
        conf = np.concatenate(self.confs)
        pcls = np.concatenate(self.pred_classes)
        gcls = np.concatenate(self.gt_classes)

        order = conf.argsort()[::-1]
        tp, conf, pcls = tp[order], conf[order], pcls[order]

        aps = np.zeros((self.nc, len(IOU_THRESHOLDS)))
        p_at, r_at = [], []
        eps = 1e-16
        # one row per class with GT: precision on a 1000-point recall axis,
        # and p / r / f1 on a 1000-point confidence axis (the ultralytics
        # PR/F1 curve layout)
        px = np.linspace(0, 1, 1000)
        present = [c for c in range(self.nc) if (gcls == c).sum() > 0]
        py = np.zeros((len(present), px.size))
        p_conf = np.zeros((len(present), px.size))
        r_conf = np.zeros((len(present), px.size))
        for ci, c in enumerate(present):
            n_gt = int((gcls == c).sum())
            mask = pcls == c
            if not mask.any():
                continue
            tpc = tp[mask].cumsum(0)
            fpc = (~tp[mask]).cumsum(0)
            recall = tpc / (n_gt + eps)
            precision = tpc / (tpc + fpc)
            for ti in range(len(IOU_THRESHOLDS)):
                aps[c, ti] = compute_ap(recall[:, ti], precision[:, ti])
            mrec, mpre = _ap_envelope(recall[:, 0], precision[:, 0])
            py[ci] = np.interp(px, mrec, mpre)
            # conf descends within the class: negate both axes for np.interp
            cconf = conf[mask]
            p_conf[ci] = np.interp(-px, -cconf, precision[:, 0], left=1.0)
            r_conf[ci] = np.interp(-px, -cconf, recall[:, 0], left=0.0)
            # P and R at the max-F1 confidence, IoU 0.5
            f1 = 2 * precision[:, 0] * recall[:, 0] / (precision[:, 0] + recall[:, 0] + eps)
            i = int(f1.argmax())
            p_at.append(precision[i, 0])
            r_at.append(recall[i, 0])

        f1_conf = 2 * p_conf * r_conf / (p_conf + r_conf + eps)
        return {
            "precision": float(np.mean(p_at)) if p_at else 0.0,
            "recall": float(np.mean(r_at)) if r_at else 0.0,
            "map50": float(aps[present, 0].mean()) if present else 0.0,
            "map": float(aps[present].mean()) if present else 0.0,
            "per_class_ap": aps,
            "curves": {"px": px, "py": py, "p": p_conf, "r": r_conf, "f1": f1_conf,
                       "classes": np.asarray(present, np.int64)},
        }


def confusion_matrix(preds: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                     gts: List[Tuple[np.ndarray, np.ndarray]], nc: int,
                     conf_thres: float = 0.25, iou_thres: float = 0.45) -> np.ndarray:
    """(nc+1, nc+1) matrix [pred_class, true_class], the last index the
    background (the ultralytics layout)."""
    mat = np.zeros((nc + 1, nc + 1), np.int64)
    for (pb, ps, pc), (gb, gc) in zip(preds, gts):
        keep = ps >= conf_thres
        pb, pc = pb[keep], pc[keep]
        iou = iou_matrix(gb, pb)
        matched_gt, matched_pred = set(), set()
        if iou.size:
            gi, pi = np.nonzero(iou >= iou_thres)
            for k in iou[gi, pi].argsort()[::-1]:
                g, p = gi[k], pi[k]
                if g in matched_gt or p in matched_pred:
                    continue
                matched_gt.add(g)
                matched_pred.add(p)
                mat[int(pc[p]), int(gc[g])] += 1
        for g in range(len(gc)):
            if g not in matched_gt:
                mat[nc, int(gc[g])] += 1  # missed: predicted background
        for p in range(len(pc)):
            if p not in matched_pred:
                mat[int(pc[p]), nc] += 1  # false positive: true background
    return mat

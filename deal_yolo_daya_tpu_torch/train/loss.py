"""Detection loss: Task-Aligned Assignment + CIoU + DFL + BCE.

Counterpart of ``deal_yolo_daya_tpu/train/loss.py``, the same arithmetic in
the same dtypes:

- the assigner's align metric ``score**alpha * CIoU**beta`` runs in bf16 even
  in an f32 run (it only ranks anchors and sits under no gradient);
- the per-GT top-k is ``topk`` successive argmaxes, ties to the lowest
  index, and a GT keeps its top-k when its best metric passes ``eps``;
- an anchor claimed by several GTs goes to the one it overlaps most;
- BCE runs in the logits' dtype (bf16 under amp) with its sum taken in f32;
  the DFL and box terms in f32.

Conventions: head outputs are the per-level NCHW maps; GT boxes arrive
padded, (B, N, 4) xyxy pixels with a (B, N) validity mask. Assignment runs in
pixels, the box and DFL losses in feature-grid units. Nothing here reads a
value back to the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox2dist, bbox_ciou, dist2bbox, make_anchors
from ..ops.decode import REG_MAX, dfl_expectation, flatten_levels


class LossConfig(NamedTuple):
    nc: int = 80
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    # True multiplies the total by the batch size, as ultralytics'
    # v8DetectionLoss does; the default normalises by the target-score sum
    # only, so the total does not grow with the batch
    batch_scale: bool = False


def select_candidates_in_gts(anchor_xy: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) pixel centres, (B, N, 4) xyxy pixels -> (B, N, A) bool: the
    anchor centre lies strictly inside the GT box."""
    lt = anchor_xy[None, None] - gt_bboxes[:, :, None, :2]
    rb = gt_bboxes[:, :, None, 2:4] - anchor_xy[None, None]
    return torch.cat([lt, rb], dim=-1).amin(dim=-1) > eps


@torch.no_grad()
def task_aligned_assign(
    pd_scores: torch.Tensor,   # (B, A, nc) sigmoid probabilities
    pd_bboxes: torch.Tensor,   # (B, A, 4) xyxy pixels
    anchor_xy: torch.Tensor,   # (A, 2) pixel centres
    gt_labels: torch.Tensor,   # (B, N) int
    gt_bboxes: torch.Tensor,   # (B, N, 4) xyxy pixels
    mask_gt: torch.Tensor,     # (B, N) bool
    nc: int,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (target_bboxes (B,A,4) pixels, target_scores (B,A,nc) f32,
    fg_mask (B,A) bool, target_gt_idx (B,A) int64)."""
    b, n, _ = gt_bboxes.shape
    a = pd_bboxes.shape[1]
    mdt = torch.bfloat16
    labels = gt_labels.long().clamp(0, nc - 1)

    # align metric in bf16: the GT's class score of each anchor times CIoU
    scores = pd_scores.to(mdt)
    gt_label_scores = torch.gather(scores, 2, labels[:, None, :].expand(b, a, n)).transpose(1, 2)
    overlaps = bbox_ciou(gt_bboxes.to(mdt)[:, :, None, :],
                         pd_bboxes.to(mdt)[:, None, :, :]).clamp(min=0)   # (B, N, A)
    align_metric = gt_label_scores ** alpha * overlaps ** beta

    mask_in_gts = select_candidates_in_gts(anchor_xy, gt_bboxes)
    valid = mask_in_gts & mask_gt[:, :, None]
    work = align_metric.masked_fill(~valid, 0.0)

    # per-GT top-k as k successive argmaxes (ties to the lowest index): only
    # membership matters. A GT whose best metric passes eps keeps all of its
    # top-k, even candidates whose own metric is ~0.
    # a Python eps compares in work's dtype (bf16), as a tensor of it would,
    # with no host-to-device copy (none may run inside a CUDA graph's capture)
    gt_has_candidate = work.amax(dim=-1, keepdim=True) > eps
    anchor_iota = torch.arange(a, device=work.device)
    mask_topk = torch.zeros((b, n, a), dtype=torch.bool, device=work.device)
    for _ in range(topk):
        sel = anchor_iota == work.argmax(dim=-1, keepdim=True)
        mask_topk |= sel
        work = work.masked_fill(sel, -1.0)
    mask_pos = mask_topk & gt_has_candidate & valid        # (B, N, A)

    # an anchor claimed by several GTs goes to the GT it overlaps most
    fg_counts = mask_pos.sum(dim=1)                                          # (B, A)
    max_overlap_gt = overlaps.masked_fill(~mask_pos, -1.0).argmax(dim=1)
    single_gt = mask_pos.to(torch.uint8).argmax(dim=1)
    target_gt_idx = torch.where(fg_counts > 1, max_overlap_gt, single_gt)
    fg_mask = fg_counts > 0
    mask_pos = F.one_hot(target_gt_idx, n).transpose(1, 2).bool() & fg_mask[:, None, :]

    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))
    target_labels = torch.gather(labels, 1, target_gt_idx)
    target_scores = F.one_hot(target_labels, nc).float() * fg_mask[..., None]

    # normalise: each positive anchor's score becomes its metric over its
    # GT's best metric, times that GT's best overlap
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(dim=-1, keepdim=True)                   # (B, N, 1)
    pos_overlap = (overlaps * mask_pos).amax(dim=-1, keepdim=True)        # (B, N, 1)
    norm_align = (align_metric * pos_overlap / (pos_align + eps)).amax(dim=1)  # (B, A)
    target_scores = target_scores * norm_align[..., None]
    return target_bboxes, target_scores, fg_mask, target_gt_idx


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (stable), in the logits'
    dtype; callers sum in f32."""
    targets = targets.to(logits.dtype)
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _dfl_loss(pd_dist: torch.Tensor, target_dist: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy against the two integer bins
    that bracket the target, linearly weighted (the two-hot form), mean over
    the 4 sides. pd_dist (..., 4, REG_MAX), target (..., 4)."""
    tl = torch.floor(target_dist)
    wr = target_dist - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(pd_dist.float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=target_dist.dtype, device=target_dist.device)
    left = tl.clamp(0, REG_MAX - 1)[..., None]
    right = (tl + 1).clamp(0, REG_MAX - 1)[..., None]
    two_hot = (bins == left) * wl[..., None] + (bins == right) * wr[..., None]
    return -(logp * two_hot).sum(dim=-1).mean(dim=-1)


def detection_loss(
    box_levels: Sequence[torch.Tensor],
    cls_levels: Sequence[torch.Tensor],
    gt_labels: torch.Tensor,   # (B, N)
    gt_bboxes: torch.Tensor,   # (B, N, 4) xyxy pixels
    gt_mask: torch.Tensor,     # (B, N) bool
    imgsz: Tuple[int, int],
    config: LossConfig = LossConfig(),
    dp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total detection loss and its parts (box/cls/dfl and the foreground
    count), all 0-d tensors on the head's device.

    With ``dp`` (a ``parallel.DataParallel``) the batch is this rank's rows
    of the global batch: the target-score sum is all-reduced before its
    clamp, so that each part is this rank's sum over the global normaliser
    and the parts summed over the ranks are the one-process loss of the
    global batch; ``batch_scale`` multiplies by the global batch."""
    pd_dist, pd_scores = flatten_levels(box_levels, cls_levels)  # (B,A,64), (B,A,nc)
    pd_dist = pd_dist.float()
    # pd_scores stays in the model dtype (bf16 under amp) for the BCE
    anchor_points, stride_per = make_anchors(imgsz, device=pd_dist.device)
    anchor_xy_px = anchor_points * stride_per

    dist_exp = dfl_expectation(pd_dist)                           # (B, A, 4)
    pd_bboxes_grid = dist2bbox(dist_exp, anchor_points[None])
    gt_bboxes = gt_bboxes.float()

    target_bboxes_px, target_scores, fg_mask, _ = task_aligned_assign(
        torch.sigmoid(pd_scores.detach()),
        (pd_bboxes_grid * stride_per[None]).detach(),
        anchor_xy_px, gt_labels, gt_bboxes, gt_mask,
        nc=config.nc, topk=config.tal_topk, alpha=config.tal_alpha, beta=config.tal_beta,
    )
    target_scores_sum = target_scores.sum()
    if dp is not None:
        dp.all_reduce_(target_scores_sum)
    target_scores_sum = target_scores_sum.clamp(min=1.0)

    cls_loss = _bce_logits(pd_scores, target_scores).sum(dtype=torch.float32) / target_scores_sum

    target_bboxes_grid = target_bboxes_px / stride_per[None]
    weight = target_scores.sum(dim=-1) * fg_mask                   # (B, A)
    ciou = bbox_ciou(pd_bboxes_grid, target_bboxes_grid)
    box_loss = ((1.0 - ciou) * weight).sum() / target_scores_sum

    target_dist = bbox2dist(target_bboxes_grid, anchor_points[None], REG_MAX)
    dfl = _dfl_loss(pd_dist.reshape(*pd_dist.shape[:-1], 4, REG_MAX), target_dist)
    dfl_loss = (dfl * weight).sum() / target_scores_sum

    total = config.box_gain * box_loss + config.cls_gain * cls_loss + config.dfl_gain * dfl_loss
    if config.batch_scale:
        total = total * (pd_scores.shape[0] * (dp.world if dp is not None else 1))
    return total, {
        "box_loss": box_loss,
        "cls_loss": cls_loss,
        "dfl_loss": dfl_loss,
        "num_fg": fg_mask.sum().float(),
    }

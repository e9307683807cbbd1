"""The numbers that decide ``correct``: the program's outputs judged
against the reference's. Each returns one number; the cell's file holds
its limit.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a key's bias under softmax): left out
NEGLIGIBLE_GRAD = 1e-3


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def fg_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest gap of a step's foreground-anchor count, over the
    reference's count (at least 1)."""
    return max(abs(p - r) / max(r, 1.0) for p, r in zip(prog, ref))


def var_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
             ) -> List[Tuple[float, str]]:
    """Each BatchNorm layer's relative gap of its batch variance vector,
    norm(prog - ref) / norm(ref); worst first."""
    return sorted(((float((prog[k].cpu() - ref[k].cpu()).norm() / ref[k].norm().clamp(min=1e-30)),
                    k) for k in ref), reverse=True)


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE_GRAD * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Iterable[str]
              ) -> List[Tuple[float, str]]:
    """Each leaf's gap of norms, |norm_prog - norm_ref|, over the larger of
    the reference's norm of that leaf and of the median leaf; worst first."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in leaves),
                  reverse=True)


def median_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: Iterable[str]) -> float:
    """The median leaf's gap of norms (``leaf_gaps``). The worst leaf's is
    no sound number in bf16: the reference itself under bf16 autocast reads
    0.5-0.9 there at initialisation (see PERF.md)."""
    return statistics.median(g for g, _ in leaf_gaps(prog, ref, leaves))


def group_gap(prog: Dict[str, float], ref: Dict[str, float],
              groups: Dict[str, List[str]]) -> float:
    """The largest over ``groups`` of the group's median leaf gap
    (``median_gap``): a fault confined to one group of leaves, such as one
    optimizer group's, moves its group's median."""
    return max(median_gap(prog, ref, names) for names in groups.values() if names)


@torch.no_grad()
def detection_gaps(served: Sequence[Tuple], cands: Sequence[Tuple], box_unit: float = 1.0,
                   score_unit: float = 0.01) -> Dict[str, float]:
    """Judge each served detection by the reference.

    ``served``: per image (boxes (n, 4), scores (n,), classes (n,)) as the
    program returned them, in the image's pixels. ``cands``: per image the
    reference's (boxes (A, 4), class scores (A, nc)) for every anchor, in
    the same pixels.

    A served detection should be one anchor's box, with the anchor's best
    class and that class's score. The anchor taken is the one that
    explains it best: the least of the largest of its box gap (px, in
    ``box_unit``), its score gap and its class gap (how far the served
    class's reference score lies under the anchor's best, both in
    ``score_unit``). Returns the worst served detection's three gaps at its
    anchor: ``box_px``, ``score`` and ``class``."""
    box_gap = score_gap = class_gap = 0.0
    for (b, s, c), (rb, rs) in zip(served, cands):
        if len(b) == 0:
            continue
        b = torch.as_tensor(b, dtype=torch.float32, device=rb.device)
        s = torch.as_tensor(s, dtype=torch.float32, device=rb.device)
        c = torch.as_tensor(c, dtype=torch.long, device=rb.device)
        best = rs.amax(-1)                                                    # (A,)
        for i in range(0, len(b), 64):
            bb, ss, cc = b[i:i + 64], s[i:i + 64], c[i:i + 64]
            dbox = (bb[:, None, :] - rb[None, :, :]).abs().amax(-1)        # (n, A)
            sc = rs[:, cc].T                                                  # (n, A)
            dscore = (ss[:, None] - sc).abs()
            dclass = best[None, :] - sc
            joint = torch.maximum(dbox / box_unit,
                                  torch.maximum(dscore, dclass) / score_unit)
            a = joint.argmin(1)
            rows = torch.arange(len(bb), device=rb.device)
            box_gap = max(box_gap, float(dbox[rows, a].max()))
            score_gap = max(score_gap, float(dscore[rows, a].max()))
            class_gap = max(class_gap, float(dclass[rows, a].max()))
    return {"box_px": box_gap, "score": score_gap, "class": class_gap}


@torch.no_grad()
def missed(served: Sequence[Tuple], kept: Sequence[Tuple], iou: float = 0.5) -> float:
    """The worst image's share of the reference's NMS detections (``kept``:
    per image boxes (k, 4) and classes (k,), in the image's pixels) that no
    served detection of the same class overlaps by IoU ``iou`` or more."""
    worst = 0.0
    for (b, _, c), (rb, rc) in zip(served, kept):
        if len(rb) == 0:
            continue
        if len(b) == 0:
            worst = 1.0
            continue
        b = torch.as_tensor(b, dtype=torch.float32, device=rb.device)
        c = torch.as_tensor(c, dtype=torch.long, device=rb.device)
        lt = torch.maximum(rb[:, None, :2], b[None, :, :2])
        br = torch.minimum(rb[:, None, 2:], b[None, :, 2:])
        inter = (br - lt).clamp(min=0).prod(-1)
        area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(-1)  # noqa: E731
        ov = inter / (area(rb)[:, None] + area(b)[None, :] - inter + 1e-9)
        found = ((ov >= iou) & (rc[:, None] == c[None, :])).any(1)
        worst = max(worst, 1.0 - float(found.float().mean()))
    return worst

"""The reference of one training step of the device-cache path: the
augmentation draws, mosaic + affine + HSV + flips + box compaction, the
detection loss (task-aligned assignment, CIoU, DFL, BCE), nesterov SGD
with the warmup schedules, and the parameter EMA. Plain PyTorch in
float32, written from the ultralytics / YOLO training recipe and the
configuration the benchmark states; nothing of the program under test.

The draws are the one place the reference must match the program's
random numbers exactly: the benchmark states them as "one
``torch.Generator`` on the card, seeded with the step's seed, drawing in
this order", and ``draws`` makes them so. Everything downstream is
computed afresh.

The augmentation samples each output pixel by its own bilinear gather
(the general formulation), where the program may take a separable path;
both are the same function up to float rounding, and the images are
truncated to uint8 at the end, so a pixel may differ by one level.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .model import REG_MAX, anchors, dfl, flatten_levels

FILL = 114.0


class AugParams(NamedTuple):
    mosaic: float = 1.0
    mixup: float = 0.0
    scale: float = 0.5
    translate: float = 0.1
    degrees: float = 0.0
    shear: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0
    bgr: float = 0.0


def draws(b: int, seed: int, p: AugParams, device) -> Dict[str, torch.Tensor]:
    """The step's random numbers, in the stated order, from one generator on
    ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(generator=g, device=device)
    partners = torch.randint(0, b, (b, 3), **kw)
    u = torch.rand((b, 10), **kw)
    hsv = torch.rand((b, 3), **kw) * 2.0 - 1.0
    gains = torch.stack([1 + hsv[:, 0] * p.hsv_h, 1 + hsv[:, 1] * p.hsv_s,
                         1 + hsv[:, 2] * p.hsv_v], -1)
    flips = torch.rand((b, 3), **kw)
    return {"partners": partners, "u": u, "gains": gains, "flips": flips}


def _rgb_hsv_rgb(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """HSV gains (OpenCV's ranges: hue in [0, 180), s and v in [0, 255]) on
    a (S, S, 3) float image, hue wrapping, s and v clipped."""
    r, g, b = img.unbind(-1)
    v = torch.max(img, -1).values
    mn = torch.min(img, -1).values
    c = v - mn
    s = torch.where(v > 0, c / v.clamp(min=1e-12), torch.zeros_like(v)) * 255.0
    cc = c.clamp(min=1e-12)
    h = torch.where(v == r, (g - b) / cc, torch.where(v == g, 2.0 + (b - r) / cc, 4.0 + (r - g) / cc))
    h = torch.where(c == 0, torch.zeros_like(h), h)
    h = torch.remainder(h * 30.0, 180.0)   # degrees / 2
    h = torch.remainder(h * gains[0], 180.0)
    s = (s * gains[1]).clamp(0, 255) / 255.0
    v = (v * gains[2]).clamp(0, 255)
    hp = h / 30.0                           # sector in [0, 6)
    k = lambda n: torch.remainder(n + hp, 6.0)  # noqa: E731
    f = lambda n: v - v * s * torch.clamp(torch.minimum(k(n), 4.0 - k(n)), 0.0, 1.0)  # noqa: E731
    return torch.stack([f(5.0), f(3.0), f(1.0)], -1).clamp(0, 255)


def augment(images, hw, boxes, classes, mask, d: Dict[str, torch.Tensor], s: int,
            p: AugParams, max_boxes: int):
    """The augmented batch: (images (B, S, S, 3) uint8, boxes (B, K, 4),
    classes (B, K), mask (B, K)) with K = min(max_boxes, 4M), kept boxes
    first. Mosaic with probability ``p.mosaic`` (else the image alone,
    centred on the 2S canvas), the random affine about the canvas centre,
    HSV gains and left-right flips; a box is kept if its sides exceed 2 px,
    at least 10% of its scaled area survives and its aspect is under 100."""
    if p.mixup or p.flipud or p.bgr:
        raise ValueError("the reference covers mosaic, affine, HSV and left-right flips")
    bsz, dev = images.shape[0], images.device
    m = boxes.shape[1]
    out_img = torch.empty((bsz, s, s, 3), dtype=torch.uint8, device=dev)
    out_boxes, out_cls, out_keep = [], [], []
    ys, xs = torch.meshgrid(torch.arange(s, dtype=torch.float32, device=dev),
                            torch.arange(s, dtype=torch.float32, device=dev), indexing="ij")
    C = float(s)
    for i in range(bsz):
        u = d["u"][i]
        src = torch.cat([torch.tensor([i], device=dev), d["partners"][i]])
        hs, ws = hw[src, 0], hw[src, 1]
        mosaic = bool(u[5] < p.mosaic)
        yc, xc = s // 2 + u[0] * s, s // 2 + u[1] * s
        if mosaic:
            ox = torch.stack([xc - ws[0], xc, xc - ws[2], xc])
            oy = torch.stack([yc - hs[0], yc - hs[1], yc, yc])
        else:
            far = torch.tensor(4.0 * s, device=dev)
            ox = torch.stack([C - ws[0] / 2, far, far, far])
            oy = torch.stack([C - hs[0] / 2, far, far, far])
        sc = 1.0 + p.scale * (2.0 * u[2] - 1.0)
        tx = (0.5 + p.translate * (2.0 * u[3] - 1.0)) * s
        ty = (0.5 + p.translate * (2.0 * u[4] - 1.0)) * s
        ang = math.radians(1.0) * p.degrees * (2.0 * u[6] - 1.0)
        shx = torch.tan(math.radians(1.0) * p.shear * (2.0 * u[7] - 1.0))
        shy = torch.tan(math.radians(1.0) * p.shear * (2.0 * u[8] - 1.0))
        # canvas -> output: out = A (canvas - C) + t, A = shear @ rotate-scale
        R = torch.stack([torch.stack([sc * torch.cos(ang), sc * torch.sin(ang)]),
                         torch.stack([-sc * torch.sin(ang), sc * torch.cos(ang)])])
        Sh = torch.stack([torch.stack([torch.ones((), device=dev), shx]),
                          torch.stack([shy, torch.ones((), device=dev)])])
        A = Sh @ R
        Ai = torch.linalg.inv(A)
        cx = Ai[0, 0] * (xs - tx) + Ai[0, 1] * (ys - ty) + C
        cy = Ai[1, 0] * (xs - tx) + Ai[1, 1] * (ys - ty) + C
        quad = ((cy >= yc).long() * 2 + (cx >= xc).long()) if mosaic \
            else torch.zeros_like(cx, dtype=torch.long)
        sx, sy = cx - ox[quad], cy - oy[quad]
        valid = (sx >= -0.5) & (sx <= ws[quad] - 0.5) & (sy >= -0.5) & (sy <= hs[quad] - 0.5)
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        img = src[quad]
        xi0, yi0 = x0.long(), y0.long()
        xa, xb = xi0.clamp(0, s - 1), (xi0 + 1).clamp(0, s - 1)
        ya, yb = yi0.clamp(0, s - 1), (yi0 + 1).clamp(0, s - 1)
        pix = lambda yy, xx: images[img, yy, xx].float()  # noqa: E731
        val = (pix(ya, xa) * (1 - fx) * (1 - fy) + pix(ya, xb) * fx * (1 - fy)
               + pix(yb, xa) * (1 - fx) * fy + pix(yb, xb) * fx * fy)
        val = torch.where(valid[..., None], val, torch.full_like(val, FILL))
        val = _rgb_hsv_rgb(val, d["gains"][i])
        flip = bool(d["flips"][i, 0] < p.fliplr)
        if flip:
            val = val.flip(1)
        out_img[i] = val.clamp(0, 255).to(torch.uint8)

        # boxes of the four sources on the canvas (clipped to it), their
        # corners through the affine, the axis-aligned box, clipped
        org = torch.stack([ox, oy, ox, oy], -1)[:, None, :]
        bc = (boxes[src] + org).reshape(-1, 4).clamp(0, 2 * s)
        x1, y1, x2, y2 = bc.unbind(-1)
        corners = torch.stack([torch.stack([x1, y1], -1), torch.stack([x2, y1], -1),
                               torch.stack([x2, y2], -1), torch.stack([x1, y2], -1)], 1)
        out = (corners - C) @ A.T + torch.stack([tx, ty])
        bx = torch.cat([out.min(1).values, out.max(1).values], -1).clamp(0, s)
        bw, bh = bx[:, 2] - bx[:, 0], bx[:, 3] - bx[:, 1]
        area0 = (x2 - x1) * (y2 - y1) * sc * sc
        ar = torch.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
        keep = (mask[src].reshape(-1) & (bw > 2) & (bh > 2)
                & (bw * bh / (area0.abs() + 1e-9) > 0.1) & (ar < 100))
        if flip:
            bx = torch.stack([s - bx[:, 2], bx[:, 1], s - bx[:, 0], bx[:, 3]], -1)
        cls = classes[src].reshape(-1)
        order = torch.cat([torch.nonzero(keep).flatten(), torch.nonzero(~keep).flatten()])
        order = order[:max_boxes]
        k = keep[order]
        out_boxes.append(bx[order] * k[:, None])
        out_cls.append(cls[order] * k)
        out_keep.append(k)
    k_out = min(max_boxes, 4 * m)
    return (out_img, torch.stack(out_boxes)[:, :k_out], torch.stack(out_cls)[:, :k_out],
            torch.stack(out_keep)[:, :k_out])


# ------------------------------------------------------------------ loss


def _iou_parts(b1, b2, eps=1e-7):
    iw = (torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0])).clamp(0)
    ih = (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1])).clamp(0)
    inter = iw * ih
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    return inter / union, w1, h1, w2, h2


def ciou(b1, b2, eps=1e-7):
    """Complete IoU of xyxy boxes (broadcasting); alpha carries no gradient."""
    iou, w1, h1, w2, h2 = _iou_parts(b1, b2, eps)
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
            + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


@torch.no_grad()
def assign(scores, pboxes, anc_px, labels, gboxes, gmask, nc, topk=10, alpha=0.5, beta=6.0,
           eps=1e-9):
    """Task-aligned assignment: each GT takes its top-k anchors (centre
    inside the GT) by score^alpha * CIoU^beta; an anchor claimed twice goes
    to the GT it overlaps most; target scores are normalised by each GT's
    best metric and best overlap."""
    b, n, _ = gboxes.shape
    a = pboxes.shape[1]
    labels = labels.long().clamp(0, nc - 1)
    s_gt = torch.gather(scores, 2, labels[:, None, :].expand(b, a, n)).transpose(1, 2)
    ov = ciou(gboxes[:, :, None, :], pboxes[:, None, :, :]).clamp(min=0)      # (B, N, A)
    metric = s_gt ** alpha * ov ** beta
    lt = anc_px[None, None] - gboxes[:, :, None, :2]
    rb = gboxes[:, :, None, 2:] - anc_px[None, None]
    inside = torch.cat([lt, rb], -1).amin(-1) > eps
    valid = inside & gmask[:, :, None]
    work = metric * valid
    top = torch.zeros_like(valid)
    top.scatter_(2, work.topk(topk, dim=-1).indices, True)
    pos = top & valid & (work.amax(-1, keepdim=True) > eps)
    count = pos.sum(1)
    best_gt = torch.where(count > 1, ov.masked_fill(~pos, -1.0).argmax(1),
                          pos.to(torch.uint8).argmax(1))
    fg = count > 0
    pos = F.one_hot(best_gt, n).transpose(1, 2).bool() & fg[:, None, :]
    t_boxes = torch.gather(gboxes, 1, best_gt[..., None].expand(b, a, 4))
    t_labels = torch.gather(labels, 1, best_gt)
    metric = metric * pos
    norm = (metric * (ov * pos).amax(-1, keepdim=True)
            / (metric.amax(-1, keepdim=True) + eps)).amax(1)
    t_scores = F.one_hot(t_labels, nc).float() * (fg * norm)[..., None]
    return t_boxes, t_scores, fg


def detection_loss(box_levels, cls_levels, labels, gboxes, gmask, imgsz: int, nc: int,
                   gains=(7.5, 0.5, 1.5)) -> Tuple[torch.Tensor, float]:
    """(gains[0] * box + gains[1] * cls + gains[2] * dfl, each normalised by
    the target-score sum (at least 1); the count of foreground anchors)."""
    pd, pc = flatten_levels(box_levels, cls_levels)
    pd, pc = pd.float(), pc.float()
    pts, st = anchors(imgsz, pd.device)
    dist = dfl(pd)
    pb = torch.cat([pts - dist[..., :2], pts + dist[..., 2:]], -1)            # grid units
    t_boxes, t_scores, fg = assign(pc.detach().sigmoid(), (pb * st).detach(), pts * st,
                                   labels, gboxes.float(), gmask, nc)
    tss = t_scores.sum().clamp(min=1.0)
    cls = F.binary_cross_entropy_with_logits(pc, t_scores, reduction="sum") / tss
    tb = t_boxes / st
    w = t_scores.sum(-1) * fg
    box = ((1.0 - ciou(pb, tb)) * w).sum() / tss
    td = torch.cat([pts - tb[..., :2], tb[..., 2:] - pts], -1).clamp(0, REG_MAX - 1.01)
    tl = td.floor()
    wr = td - tl
    logp = pd.view(*pd.shape[:-1], 4, REG_MAX).log_softmax(-1)
    left = torch.gather(logp, -1, tl.long()[..., None])[..., 0]
    right = torch.gather(logp, -1, (tl.long() + 1).clamp(max=REG_MAX - 1)[..., None])[..., 0]
    dfl_l = (-(left * (1 - wr) + right * wr)).mean(-1)
    dfl_loss = (dfl_l * w).sum() / tss
    return gains[0] * box + gains[1] * cls + gains[2] * dfl_loss, float(fg.sum())


# ------------------------------------------------------------------ optimizer


class SGD:
    """Nesterov SGD over three groups (conv kernels with weight decay, BN
    weights, biases), with the warmup schedules: the main lr rises
    linearly from 0 and the bias lr falls from ``warmup_bias_lr`` toward
    the decayed lr over ``warmup_epochs`` epochs, momentum rises from
    ``warmup_momentum``; then linear decay to ``lr0 * lrf``. The parameter
    EMA follows with decay 0.9999 * (1 - exp(-updates / 2000))."""

    def __init__(self, named: List[Tuple[str, torch.Tensor]], hp: Dict, steps_per_epoch: int):
        self.hp = hp
        self.warm = int(hp["warmup_epochs"] * steps_per_epoch)
        self.total = max(hp["epochs"] * steps_per_epoch, self.warm + 1)
        self.params = named
        self.buf = {k: torch.zeros_like(p) for k, p in named}
        self.ema = {k: p.detach().clone() for k, p in named}
        self.updates = 0

    def _lr(self, step: int, start: float) -> float:
        frac = min(max((step - self.warm) / max(self.total - self.warm, 1), 0.0), 1.0)
        target = self.hp["lr0"] * (1.0 - (1.0 - self.hp["lrf"]) * frac)
        if step >= self.warm:
            return target
        return start + (target - start) * step / self.warm

    def momentum(self, t: int) -> float:
        """The momentum of update ``t`` (0-based)."""
        if not self.warm:
            return self.hp["momentum"]
        return self.hp["warmup_momentum"] + (self.hp["momentum"] - self.hp["warmup_momentum"]) \
            * min(t / self.warm, 1.0)

    @staticmethod
    def group(k: str, ndim: int) -> str:
        """A leaf's group by its name and number of dimensions: ``bias``,
        ``decay`` (conv kernels) or ``no_decay``."""
        if k.endswith("bias"):
            return "bias"
        return "decay" if ndim == 4 else "no_decay"

    def decay(self, k: str, ndim: int) -> float:
        """A leaf's weight decay."""
        return self.hp["weight_decay"] if self.group(k, ndim) == "decay" else 0.0

    @torch.no_grad()
    def step(self) -> None:
        t = self.updates
        mom = self.momentum(t)
        for k, p in self.params:
            lr = self._lr(t, self.hp["warmup_bias_lr"] if self.group(k, p.dim()) == "bias"
                          else 0.0)
            d = p.grad + self.decay(k, p.dim()) * p
            self.buf[k] = mom * self.buf[k] + d
            p -= lr * (d + mom * self.buf[k])
        self.updates += 1
        decay = 0.9999 * (1 - math.exp(-self.updates / 2000.0))
        for k, p in self.params:
            self.ema[k] = self.ema[k] * decay + p.detach() * (1 - decay)

"""A plain PyTorch YOLOv10 (the NMS-free dual-head detector), its training
loss and its selection: the reference that the port's YOLOv10 is held to.

Written from Wang et al., "YOLOv10: Real-Time End-to-End Object Detection"
(arXiv:2405.14458) and ultralytics' ``cfg/models/v10/yolov10{n,s,m,b,l,x}.
yaml`` with the modules they name (``SCDown``, ``C2fCIB``/``CIB``,
``RepVGGDW``, ``PSA``, ``v10Detect``, ``E2EDetectLoss``), in float32 with
nothing of the program under test: it imports torch alone. Submodules carry
the ultralytics ``DetectionModel`` names without the ``model.`` prefix
("0.conv.weight", "10.attn.qkv.conv.weight", "23.one2one_cv3.0.2.bias").

- ``Detector(cfg)``: the network of ``cfg`` (``scale``, ``depth_multiple``,
  ``width_multiple``, ``max_channels``, ``nc``). In training its forward
  returns ``{"one2many": (box, cls), "one2one": (box, cls)}``, per-level
  raw maps, the one-to-one branches fed ``detach()``ed features; in eval
  mode the one-to-one head's (box, cls) alone.
- ``assign(..., topk)``: task-aligned assignment with top-k as a parameter.
- ``detection_loss(..., topk)`` and ``dual_loss``: the one-to-many head's
  loss at top-k 10 plus the one-to-one head's at top-k 1, the same gains.
- ``decode`` and ``postprocess``: boxes and class scores from the raw maps,
  and the one-to-one head's selection (``v10Detect.postprocess``, then the
  confidence threshold, ``>``).

Departures from the paper and ultralytics, each a convention the port's
configuration states:
- BatchNorm eps 1e-3 with flax's running-statistics rule (momentum 0.97
  toward the batch mean and the *biased* batch variance), where ultralytics
  uses PyTorch's BatchNorm (unbiased variance in the running estimate);
- the loss normalises each part by the target-score sum (at least 1) and
  does not multiply the total by the batch size;
- the task-aligned top-k breaks ties toward the lower anchor index;
- ``Precision("fp8")`` (``set_precision``) rounds every conv's and
  attention product's operands and every activation onto float8 e4m3 (each
  tensor scaled by its largest magnitude), their gradients onto e5m2: a
  control that must fail a comparison the float32 reference passes. The
  default, "f32", rounds nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.97
REG_MAX = 16
STRIDES = (8, 16, 32)
# where each scale's yaml puts C2fCIB (the other C2f slots stay C2f), and
# the scales whose CIBs take RepVGGDW (``lk``)
CIB_AT = {"n": (22,), "s": (8, 22), "m": (8, 19, 22), "b": (8, 13, 19, 22),
          "l": (8, 13, 19, 22), "x": (6, 8, 13, 19, 22)}
LARGE_KERNEL = ("n", "s")


# ----------------------------------------------------------------- precision


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """How operands and activations round: "f32" (not at all) or "fp8"."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "f32" else _RoundFP8.apply(x)


PREC = [Precision()]


def set_precision(name: str) -> None:
    """Every product and activation rounds as ``name`` says from now on."""
    PREC[0] = Precision(name)


def _r(x: torch.Tensor) -> torch.Tensor:
    return PREC[0].round(x)


class f32_exact:
    """Float32 products without TF32 inside the block (restored after)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# ------------------------------------------------------------------ modules


class BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(mean.detach() * (1 - BN_MOMENTUM))
                self.running_var.mul_(BN_MOMENTUM).add_(var.detach() * (1 - BN_MOMENTUM))
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose operands round as the current precision says."""

    def forward(self, x):
        y = F.conv2d(_r(x), _r(self.weight), None, self.stride, self.padding, 1, self.groups)
        return _r(y if self.bias is None else y + self.bias[:, None, None])


class Conv(nn.Module):
    """ultralytics ``Conv``: conv (no bias, k // 2 padding) + BN + SiLU."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BN(c2)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return _r(F.silu(y) if self.act else y)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=0.5):
        super().__init__()
        h = int(c2 * e)
        self.cv1, self.cv2 = Conv(c1, h, 3), Conv(h, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return _r(x + y) if self.add else y


class C2f(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=False, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, 1.0) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class RepVGGDW(nn.Module):
    """SiLU(depthwise 7x7 Conv + depthwise 3x3 Conv), neither activated."""

    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 7, 1, g=c, act=False)
        self.conv1 = Conv(c, c, 3, 1, g=c, act=False)

    def forward(self, x):
        return _r(F.silu(_r(self.conv(x) + self.conv1(x))))


class CIB(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=0.5, lk=False):
        super().__init__()
        h = int(c2 * e)
        self.cv1 = nn.Sequential(
            Conv(c1, c1, 3, g=c1), Conv(c1, 2 * h, 1),
            RepVGGDW(2 * h) if lk else Conv(2 * h, 2 * h, 3, g=2 * h),
            Conv(2 * h, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return _r(x + y) if self.add else y


class C2fCIB(C2f):
    def __init__(self, c1, c2, n=1, shortcut=False, lk=False, e=0.5):
        super().__init__(c1, c2, n, shortcut, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, 1.0, lk) for _ in range(n))


class SCDown(nn.Module):
    def __init__(self, c1, c2, k=3, s=2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        h = c1 // 2
        self.cv1, self.cv2, self.k = Conv(c1, h), Conv(4 * h, c2), k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """ultralytics ``Attention``: heads of head_dim = dim // num_heads, q and
    k of key_dim = head_dim / 2, channels per head laid out q|k|v, scale
    key_dim^-0.5, a depthwise 3x3 positional encoding on v."""

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = Conv(dim, dim + self.key_dim * num_heads * 2, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).view(b, self.num_heads, self.key_dim * 2 + self.head_dim, h * w)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        a = torch.einsum("bhdq,bhdk->bhqk", _r(q), _r(k)) * self.scale
        a = a.softmax(-1)
        out = _r(torch.einsum("bhdk,bhqk->bhdq", _r(v), _r(a))).reshape(b, c, h, w)
        return self.proj(_r(out + self.pe(v.reshape(b, c, h, w))))


class PSA(nn.Module):
    """ultralytics ``PSA`` (YOLOv10): split, attention and FFN (both
    residual) on one half, concat, 1x1."""

    def __init__(self, c1, c2, e=0.5):
        super().__init__()
        assert c1 == c2
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.attn = Attention(self.c, attn_ratio=0.5, num_heads=self.c // 64)
        self.ffn = nn.Sequential(Conv(self.c, self.c * 2, 1), Conv(self.c * 2, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        b = _r(b + self.attn(b))
        b = _r(b + self.ffn(b))
        return self.cv2(torch.cat((a, b), 1))


def _branches(nc, ch):
    c2 = max(16, ch[0] // 4, REG_MAX * 4)
    c3 = max(ch[0], min(nc, 100))
    box = nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * REG_MAX, 1))
                        for x in ch)
    cls = nn.ModuleList(nn.Sequential(
        nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
        nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
        Conv2d(c3, nc, 1)) for x in ch)
    return box, cls


class V10Detect(nn.Module):
    """``v10Detect``: the one-to-many branches cv2 (box bins) and cv3
    (classes, depthwise-separable), and their copies one2one_cv2/one2one_cv3
    on the detached features."""

    def __init__(self, nc, ch):
        super().__init__()
        self.cv2, self.cv3 = _branches(nc, ch)
        self.one2one_cv2, self.one2one_cv3 = _branches(nc, ch)

    def forward(self, feats):
        detached = [f.detach() for f in feats]
        one2one = ([m(x) for m, x in zip(self.one2one_cv2, detached)],
                   [m(x) for m, x in zip(self.one2one_cv3, detached)])
        if not self.training:
            return one2one
        one2many = ([m(x) for m, x in zip(self.cv2, feats)],
                    [m(x) for m, x in zip(self.cv3, feats)])
        return {"one2many": one2many, "one2one": one2one}


def _width(c, width, max_channels):
    v = min(c, max_channels) * width
    return max(8, int(v + 4) // 8 * 8)


def _depth(n, depth):
    return max(round(n * depth), 1)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Detector(nn.Module):
    """YOLOv10 of one scale from its configuration; forward on (B, 3, H, W)
    images in [0, 1] (see the module docstring for what it returns)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        scale, nc = cfg["scale"], cfg["nc"]
        w = lambda c: _width(c, cfg["width_multiple"], cfg["max_channels"])  # noqa: E731
        d = lambda n: _depth(n, cfg["depth_multiple"])  # noqa: E731
        lk = scale in LARGE_KERNEL

        def c2f(i, c1, c2, n, shortcut):
            return C2fCIB(c1, c2, n, True, lk) if i in CIB_AT[scale] else C2f(c1, c2, n, shortcut)

        layers = {
            0: Conv(3, w(64), 3, 2), 1: Conv(w(64), w(128), 3, 2),
            2: c2f(2, w(128), w(128), d(3), True), 3: Conv(w(128), w(256), 3, 2),
            4: c2f(4, w(256), w(256), d(6), True), 5: SCDown(w(256), w(512), 3, 2),
            6: c2f(6, w(512), w(512), d(6), True), 7: SCDown(w(512), w(1024), 3, 2),
            8: c2f(8, w(1024), w(1024), d(3), True), 9: SPPF(w(1024), w(1024), 5),
            10: PSA(w(1024), w(1024)),
            13: c2f(13, w(1024) + w(512), w(512), d(3), False),
            16: c2f(16, w(512) + w(256), w(256), d(3), False),
            17: Conv(w(256), w(256), 3, 2),
            19: c2f(19, w(256) + w(512), w(512), d(3), False),
            20: SCDown(w(512), w(512), 3, 2),
            22: c2f(22, w(512) + w(1024), w(1024), d(3), False),
            23: V10Detect(nc, (w(256), w(512), w(1024))),
        }
        for i, m in layers.items():
            self.add_module(str(i), m)

    def forward(self, x, call=None):
        """``call(module, *inputs)`` runs each top-level module (by default
        the module itself: a caller may pass one that recomputes blocks in
        the backward)."""
        call = call or (lambda mod, *a: mod(*a))
        m = lambda i: (lambda *a: call(self._modules[str(i)], *a))  # noqa: E731
        p3 = m(4)(m(3)(m(2)(m(1)(m(0)(x)))))
        p4 = m(6)(m(5)(p3))
        p5 = m(10)(m(9)(m(8)(m(7)(p4))))
        h13 = m(13)(torch.cat([_up(p5), p4], 1))
        h16 = m(16)(torch.cat([_up(h13), p3], 1))
        h19 = m(19)(torch.cat([m(17)(h16), h13], 1))
        h22 = m(22)(torch.cat([m(20)(h19), p5], 1))
        return m(23)([h16, h19, h22])


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device, gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """Weights for ``Detector(cfg)`` from ``seed``, made on ``device`` by one
    generator: every conv kernel normal with variance gain / fan_in, cut at
    2 std (one draw for all kernels, cut to shape, in state-dict order);
    BatchNorm at identity; both heads' box biases 1 and class biases
    ultralytics' prior log(5 / nc / (640 / stride)^2)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    with torch.device(device):
        model = Detector(cfg)
    sd = model.state_dict()
    for v in sd.values():
        v.zero_()
    convs = [(k, v.shape) for k, v in sd.items() if k.endswith("weight") and v.dim() == 4]
    flat = torch.randn(sum(math.prod(s) for _, s in convs), generator=gen, device=device)
    off = 0
    for k, shape in convs:
        n = math.prod(shape)
        std = (gain / math.prod(shape[1:])) ** 0.5
        sd[k].copy_((flat[off:off + n].view(shape) * std).clamp(-2 * std, 2 * std))
        off += n
    for k, v in sd.items():
        if k.endswith("running_var") or k.endswith("bn.weight"):
            v.fill_(1.0)
    for box, cls in (("cv2", "cv3"), ("one2one_cv2", "one2one_cv3")):
        for i, stride in enumerate(STRIDES):
            sd[f"23.{box}.{i}.2.bias"].fill_(1.0)
            sd[f"23.{cls}.{i}.2.bias"].fill_(math.log(5 / cfg["nc"] / (640 / stride) ** 2))
    return {k: v.detach().clone() for k, v in sd.items()}


# --------------------------------------------------------- decode and select


def flatten_levels(box: Sequence[torch.Tensor], cls: Sequence[torch.Tensor]):
    """Per-level NCHW maps -> (B, A, 64), (B, A, nc), anchors row-major."""
    return (torch.cat([x.flatten(2).transpose(1, 2) for x in box], 1),
            torch.cat([x.flatten(2).transpose(1, 2) for x in cls], 1))


def anchors(imgsz: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (A, 2) in grid units and strides (A, 1)."""
    pts, strides = [], []
    for s in STRIDES:
        n = imgsz // s
        r = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(r, r, indexing="ij")
        pts.append(torch.stack([gx.flatten(), gy.flatten()], -1))
        strides.append(torch.full((n * n, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def dfl(box: torch.Tensor) -> torch.Tensor:
    """(B, A, 64) bin logits -> (B, A, 4) expected distances (l, t, r, b)."""
    p = box.view(*box.shape[:-1], 4, REG_MAX).softmax(-1)
    return p @ torch.arange(REG_MAX, dtype=p.dtype, device=p.device)


def decode(box, cls, imgsz: int):
    """Raw head outputs -> (boxes xyxy pixels (B, A, 4), class scores (B, A, nc))."""
    b, c = flatten_levels(box, cls)
    pts, st = anchors(imgsz, b.device)
    d = dfl(b.float())
    return torch.cat([pts - d[..., :2], pts + d[..., 2:]], -1) * st, c.float().sigmoid()


def postprocess(boxes, scores, max_det: int = 300, conf: float = 0.0):
    """``v10Detect.postprocess`` then the confidence threshold: per image a
    list of (box (4,), score, class) for the min(max_det, A) anchors of the
    highest class score, then as many top (anchor, class) scores among
    them, those with a score above ``conf``, in score order."""
    b, a, nc = scores.shape
    k = min(max_det, a)
    index = scores.amax(-1).topk(k)[1].unsqueeze(-1)
    boxes = boxes.gather(1, index.repeat(1, 1, 4))
    scores = scores.gather(1, index.repeat(1, 1, nc))
    scores, index = scores.flatten(1).topk(k)
    out = []
    for i in range(b):
        keep = scores[i] > conf
        out.append((boxes[i, index[i] // nc][keep], scores[i][keep], (index[i] % nc)[keep]))
    return out


# ------------------------------------------------------------------ loss


def ciou(b1, b2, eps=1e-7):
    """Complete IoU of xyxy boxes (broadcasting); alpha carries no gradient."""
    iw = (torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0])).clamp(0)
    ih = (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1])).clamp(0)
    inter = iw * ih
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
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
    """Task-aligned assignment: each GT takes its ``topk`` anchors (centre
    inside the GT) by score^alpha * CIoU^beta, ties to the lower anchor
    index (a stable sort: ultralytics' ``topk`` leaves tie order open); an
    anchor claimed twice goes to the GT it overlaps most; target scores are
    normalised by each GT's best metric and best overlap."""
    b, n, _ = gboxes.shape
    a = pboxes.shape[1]
    labels = labels.long().clamp(0, nc - 1)
    s_gt = torch.gather(scores, 2, labels[:, None, :].expand(b, a, n)).transpose(1, 2)
    ov = ciou(gboxes[:, :, None, :], pboxes[:, None, :, :]).clamp(min=0)     # (B, N, A)
    metric = s_gt ** alpha * ov ** beta
    lt = anc_px[None, None] - gboxes[:, :, None, :2]
    rb = gboxes[:, :, None, 2:] - anc_px[None, None]
    inside = torch.cat([lt, rb], -1).amin(-1) > eps
    valid = inside & gmask[:, :, None]
    work = metric * valid
    top = torch.zeros_like(valid)
    top.scatter_(2, torch.sort(work, dim=-1, descending=True, stable=True).indices[..., :topk],
                 True)
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
                   gains=(7.5, 0.5, 1.5), topk: int = 10):
    """(gains[0] * box + gains[1] * cls + gains[2] * dfl, each normalised by
    the target-score sum (at least 1); the count of foreground anchors)."""
    pd, pc = flatten_levels(box_levels, cls_levels)
    pd, pc = pd.float(), pc.float()
    pts, st = anchors(imgsz, pd.device)
    dist = dfl(pd)
    pb = torch.cat([pts - dist[..., :2], pts + dist[..., 2:]], -1)            # grid units
    t_boxes, t_scores, fg = assign(pc.detach().sigmoid(), (pb * st).detach(), pts * st,
                                   labels, gboxes.float(), gmask, nc, topk)
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
    dfl_loss = ((-(left * (1 - wr) + right * wr)).mean(-1) * w).sum() / tss
    return gains[0] * box + gains[1] * cls + gains[2] * dfl_loss, fg.sum()


def dual_loss(outputs: Dict, labels, gboxes, gmask, imgsz: int, nc: int,
              gains=(7.5, 0.5, 1.5)):
    """``E2EDetectLoss``: the one-to-many head's loss at top-k 10 plus the
    one-to-one head's at top-k 1 -> (total, (fg one-to-many, fg one-to-one))."""
    l1, fg1 = detection_loss(*outputs["one2many"], labels, gboxes, gmask, imgsz, nc, gains, 10)
    l2, fg2 = detection_loss(*outputs["one2one"], labels, gboxes, gmask, imgsz, nc, gains, 1)
    return l1 + l2, (fg1, fg2)


def first_attention() -> int:
    """The top-level index of the PSA block, the detector's one attention."""
    return 10

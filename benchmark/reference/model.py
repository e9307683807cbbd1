"""Plain PyTorch YOLO11 and YOLOv12 detectors: the benchmark's reference.

Written from the published ultralytics definitions (``cfg/models/11/
yolo11.yaml`` and ``cfg/models/12/yolo12.yaml`` and the modules they name),
in float32, with no kernel of the program under test. Submodules carry the
ultralytics ``DetectionModel`` names without the ``model.`` prefix
("0.conv.weight", "23.cv3.0.2.bias"), so one state dict loads into this
model and into the program's with ``strict=True``.

Conventions of the program that the reference follows, as its
configuration states them: BatchNorm eps 1e-3 with flax's running-statistics
rule (momentum 0.97 toward the batch mean and the *biased* batch variance),
no ``num_batches_tracked``; symmetric k // 2 padding.

``Precision`` selects how operands and activations round: ``"f32"`` (the
reference: nothing rounds) or ``"fp8"`` (the control that must fail the
comparison: where the program under bf16 autocast holds a bf16 tensor, the
operands of every conv and attention product, every conv's and block's
output and every residual sum, the control holds it in float8 e4m3, each
tensor scaled by its largest magnitude; in training each such tensor's
gradient is rounded onto e5m2).
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


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` scaled by its largest magnitude onto an fp8 format and back."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    """fp8 training's rounding of one operand: e4m3 forward, and its
    gradient in e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """How the operands of every product round: "f32" (as they are) or
    "fp8" (the control: e4m3 operands, their gradients e5m2)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "f32" else _RoundFP8.apply(x)


def _width(c: int, width: float, max_channels: int) -> int:
    v = min(c, max_channels) * width
    return max(8, int(v + 4) // 8 * 8)


def _depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


def _r(x: torch.Tensor) -> torch.Tensor:
    """An activation as the current precision stores it."""
    return Conv2d.prec.round(x)


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
    """nn.Conv2d whose operands round as ``prec`` says."""

    prec = Precision()

    def forward(self, x):
        w = self.prec.round(self.weight)
        y = F.conv2d(self.prec.round(x), w, None, self.stride, self.padding, 1, self.groups)
        return self.prec.round(y if self.bias is None else y + self.bias[:, None, None])


class Conv(nn.Module):
    """Conv (no bias) + BN + optional SiLU: ultralytics' ``Conv``."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BN(c2)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return _r(F.silu(y) if self.act else y)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, k=(3, 3), e=0.5):
        super().__init__()
        h = int(c2 * e)
        self.cv1, self.cv2 = Conv(c1, h, k[0]), Conv(h, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return _r(x + y) if self.add else y


class C3k(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5, k=3):
        super().__init__()
        h = int(c2 * e)
        self.cv1, self.cv2, self.cv3 = Conv(c1, h), Conv(c1, h), Conv(2 * h, c2)
        self.m = nn.Sequential(*(Bottleneck(h, h, shortcut, (k, k), 1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, shortcut=True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c)
        self.cv2 = Conv((2 + n) * self.c, c2)
        self.m = nn.ModuleList(C3k(self.c, self.c, 2, shortcut) if c3k
                               else Bottleneck(self.c, self.c, shortcut) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


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


def _attend(q, k, v, scale, prec: Precision):
    """q, k (B, heads, d_k, N), v (B, heads, d_v, N) -> (B, heads, d_v, N)."""
    a = torch.einsum("bhdq,bhdk->bhqk", prec.round(q), prec.round(k)) * scale
    a = a.softmax(-1)
    return prec.round(torch.einsum("bhdk,bhqk->bhdq", prec.round(v), prec.round(a)))


class Attention(nn.Module):
    """ultralytics ``Attention`` (C2PSA): heads of head_dim, q/k of key_dim =
    head_dim * attn_ratio, channels per head laid out q|k|v."""

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
        out = _attend(q, k, v, self.scale, Conv2d.prec).reshape(b, c, h, w)
        return self.proj(_r(out + self.pe(v.reshape(b, c, h, w))))


class PSABlock(nn.Module):
    def __init__(self, c, num_heads):
        super().__init__()
        self.attn = Attention(c, num_heads, 0.5)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x):
        x = _r(x + self.attn(x))
        return _r(x + self.ffn(x))


class C2PSA(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1, self.cv2 = Conv(c1, 2 * self.c, 1), Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, self.c // 64) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class AAttn(nn.Module):
    """ultralytics ``AAttn`` (YOLOv12): attention inside each of ``area``
    row-major stripes, heads of dim // num_heads, per-head q|k|v."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area, self.num_heads = area, num_heads
        self.head_dim = dim // num_heads
        self.qkv = Conv(dim, dim * 3, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        n, a = h * w, self.area
        # (B, N, 3C) tokens in row-major order, split into ``a`` stripes
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(b * a, n // a, 3 * c)
        qkv = qkv.view(b * a, n // a, self.num_heads, 3 * self.head_dim).permute(0, 2, 3, 1)
        q, k, v = qkv.split([self.head_dim] * 3, dim=2)
        out = _attend(q, k, v, self.head_dim ** -0.5, Conv2d.prec)  # (BA, heads, hd, n/a)
        out = out.permute(0, 3, 1, 2).reshape(b, n, c).transpose(1, 2).reshape(b, c, h, w)
        v = v.permute(0, 3, 1, 2).reshape(b, n, c).transpose(1, 2).reshape(b, c, h, w)
        return self.proj(_r(out + self.pe(v)))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        h = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, h, 1), Conv(h, dim, 1, act=False))

    def forward(self, x):
        x = _r(x + self.attn(x))
        return _r(x + self.mlp(x))


class A2C2f(nn.Module):
    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0, e=0.5,
                 shortcut=True):
        super().__init__()
        h = int(c2 * e)
        self.cv1, self.cv2 = Conv(c1, h, 1), Conv((1 + n) * h, c2, 1)
        self.gamma = nn.Parameter(0.01 * torch.ones(c2)) if a2 and residual else None
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(h, h // 32, mlp_ratio, area) for _ in range(2))) if a2
            else C3k(h, h, 2, shortcut) for _ in range(n))

    def forward(self, x):
        y = [self.cv1(x)]
        for m in self.m:
            y.append(m(y[-1]))
        y = self.cv2(torch.cat(y, 1))
        return y if self.gamma is None else _r(x + self.gamma.view(-1, 1, 1) * y)


class Detect(nn.Module):
    """The decoupled head: box branch cv2 (4 * REG_MAX bins), class branch
    cv3 (depthwise-separable, YOLO11's), raw per-level outputs."""

    def __init__(self, nc, ch):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                                               Conv2d(c2, 4 * REG_MAX, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
            nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
            Conv2d(c3, nc, 1)) for x in ch)

    def forward(self, feats):
        return [m(x) for m, x in zip(self.cv2, feats)], [m(x) for m, x in zip(self.cv3, feats)]


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Detector(nn.Module):
    """A YOLO11 or YOLOv12 detector of one scale from its configuration
    (``family``, ``depth_multiple``, ``width_multiple``, ``max_channels``,
    ``nc``); forward on (B, 3, H, W) images in [0, 1] -> per-level raw
    (box, cls) maps."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.family = cfg["family"]
        dm, wm, mc, nc = cfg["depth_multiple"], cfg["width_multiple"], cfg["max_channels"], \
            cfg["nc"]
        w = lambda c: _width(c, wm, mc)  # noqa: E731
        d = lambda n: _depth(n, dm)  # noqa: E731
        big = cfg.get("scale") in ("m", "l", "x")
        if self.family == "yolo11":
            layers = {
                0: Conv(3, w(64), 3, 2), 1: Conv(w(64), w(128), 3, 2),
                2: C3k2(w(128), w(256), d(2), big, 0.25), 3: Conv(w(256), w(256), 3, 2),
                4: C3k2(w(256), w(512), d(2), big, 0.25), 5: Conv(w(512), w(512), 3, 2),
                6: C3k2(w(512), w(512), d(2), True), 7: Conv(w(512), w(1024), 3, 2),
                8: C3k2(w(1024), w(1024), d(2), True), 9: SPPF(w(1024), w(1024), 5),
                10: C2PSA(w(1024), w(1024), d(2)),
                13: C3k2(w(1024) + w(512), w(512), d(2), big),
                16: C3k2(w(512) + w(512), w(256), d(2), big), 17: Conv(w(256), w(256), 3, 2),
                19: C3k2(w(256) + w(512), w(512), d(2), big), 20: Conv(w(512), w(512), 3, 2),
                22: C3k2(w(512) + w(1024), w(1024), d(2), True),
                23: Detect(nc, (w(256), w(512), w(1024))),
            }
        elif self.family == "yolo12":
            res = cfg.get("scale") in ("l", "x")
            mlp = 1.2 if res else 2.0
            layers = {
                0: Conv(3, w(64), 3, 2), 1: Conv(w(64), w(128), 3, 2),
                2: C3k2(w(128), w(256), d(2), big, 0.25), 3: Conv(w(256), w(256), 3, 2),
                4: C3k2(w(256), w(512), d(2), big, 0.25), 5: Conv(w(512), w(512), 3, 2),
                6: A2C2f(w(512), w(512), d(4), True, 4, res, mlp),
                7: Conv(w(512), w(1024), 3, 2),
                8: A2C2f(w(1024), w(1024), d(4), True, 1, res, mlp),
                11: A2C2f(w(1024) + w(512), w(512), d(2), False, 1),
                14: A2C2f(w(512) + w(512), w(256), d(2), False, 1),
                15: Conv(w(256), w(256), 3, 2),
                17: A2C2f(w(256) + w(512), w(512), d(2), False, 1),
                18: Conv(w(512), w(512), 3, 2),
                20: C3k2(w(512) + w(1024), w(1024), d(2), True),
                21: Detect(nc, (w(256), w(512), w(1024))),
            }
        else:
            raise ValueError(f"no reference for family {self.family}")
        for i, m in layers.items():
            self.add_module(str(i), m)

    def forward(self, x) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        m = lambda i: self._modules[str(i)]  # noqa: E731
        if self.family == "yolo11":
            p3 = m(4)(m(3)(m(2)(m(1)(m(0)(x)))))
            p4 = m(6)(m(5)(p3))
            p5 = m(10)(m(9)(m(8)(m(7)(p4))))
            h13 = m(13)(torch.cat([_up(p5), p4], 1))
            h16 = m(16)(torch.cat([_up(h13), p3], 1))
            h19 = m(19)(torch.cat([m(17)(h16), h13], 1))
            h22 = m(22)(torch.cat([m(20)(h19), p5], 1))
            return m(23)((h16, h19, h22))
        p3 = m(4)(m(3)(m(2)(m(1)(m(0)(x)))))
        p4 = m(6)(m(5)(p3))
        p5 = m(8)(m(7)(p4))
        h11 = m(11)(torch.cat([_up(p5), p4], 1))
        h14 = m(14)(torch.cat([_up(h11), p3], 1))
        h17 = m(17)(torch.cat([m(15)(h14), h11], 1))
        h20 = m(20)(torch.cat([m(18)(h17), p5], 1))
        return m(21)((h14, h17, h20))


def first_attention(cfg: Dict) -> int:
    """The top-level index of the detector's first module with attention."""
    with torch.device("meta"):
        model = Detector(cfg)
    return min(int(name.split(".")[0]) for name, m in model.named_modules()
               if isinstance(m, (Attention, AAttn)))


def set_precision(name: str) -> None:
    """Every reference product rounds as ``name`` ("f32" or "fp8") from now on."""
    Conv2d.prec = Precision(name)


class f32_exact:
    """Float32 products without TF32 inside the block (restored after)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device, imgsz: int, spec: Dict,
                 calib_images: int = 4) -> Dict[str, torch.Tensor]:
    """Weights for the detector of ``cfg`` from ``seed``, made on ``device``
    by one generator in a few large calls, as a float32 state dict. ``spec``
    (the cell's ``weights``):

    - ``gain``: every conv kernel normal with variance gain / fan_in, cut at
      2 std (one draw for all kernels, cut to shape); BatchNorm at identity
      (running mean 0, variance 1), other biases 0. Gain 1 is the
      published init's scale; under training-mode BatchNorm the scale of a
      kernel before a BatchNorm does not matter. In eval mode a random
      network's activations shrink layer by layer at gain 1 (outputs all
      but constant) and blow up, sensitive to every rounding, above ~2.4;
      inference cells take a gain between, where outputs follow the input;
    - ``class_bias``: ``"prior"`` (ultralytics' init, log(5 / nc / (640 /
      stride)^2): a detector before training) or ``"zero"`` (every anchor's
      best class clears conf 0.25, so NMS sees a dense set of candidates),
      and the box biases 1.0;
    - ``head_std`` (optional, [box, class]): the head's last convs scaled so
      that their outputs have these standard deviations (eval mode, over
      ``calib_images`` painted images from the seed), as a trained head's
      logits spread.
    """
    from ..lib.traffic import paint

    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    with torch.device(device):
        model = Detector(cfg)
    sd = model.state_dict()
    for v in sd.values():
        v.zero_()
    convs = [(k, v.shape) for k, v in sd.items() if k.endswith("weight") and v.dim() == 4]
    total = sum(math.prod(s) for _, s in convs)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    for k, shape in convs:
        n = math.prod(shape)
        std = (spec["gain"] / math.prod(shape[1:])) ** 0.5
        sd[k].copy_((flat[off:off + n].view(shape) * std).clamp(-2 * std, 2 * std))
        off += n
    for k, v in sd.items():
        if k.endswith("running_var") or k.endswith("bn.weight"):
            v.fill_(1.0)
        elif k.endswith("gamma"):
            v.fill_(0.01)
    head = str(max(int(k.split(".")[0]) for k in sd))
    nc = cfg["nc"]
    for i, stride in enumerate(STRIDES):
        sd[f"{head}.cv2.{i}.2.bias"].fill_(1.0)
        sd[f"{head}.cv3.{i}.2.bias"].fill_(
            math.log(5 / nc / (640 / stride) ** 2) if spec["class_bias"] == "prior" else 0.0)
    if spec.get("head_std"):
        x = torch.stack([paint((imgsz, imgsz), gen, device) for _ in range(calib_images)])
        with f32_exact():
            box, cls = model.eval()(x.permute(0, 3, 1, 2).float() / 255.0)
        for branch, outs, target in (("cv2", box, spec["head_std"][0]),
                                     ("cv3", cls, spec["head_std"][1])):
            for i, y in enumerate(outs):
                w = sd[f"{head}.{branch}.{i}.2.weight"]
                w.mul_(target / (y - y.mean((0, 2, 3), keepdim=True)).std().clamp(min=1e-30))
    return {k: v.detach().clone() for k, v in sd.items()}


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


def decode(box: Sequence[torch.Tensor], cls: Sequence[torch.Tensor], imgsz: int):
    """Raw head outputs -> (boxes xyxy letterbox pixels (B, A, 4), class
    scores (B, A, nc))."""
    b, c = flatten_levels(box, cls)
    pts, st = anchors(imgsz, b.device)
    d = dfl(b.float())
    xyxy = torch.cat([pts - d[..., :2], pts + d[..., 2:]], -1) * st
    return xyxy, c.float().sigmoid()

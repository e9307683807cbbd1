"""YOLO11 detection network (scales n to x) as a PyTorch module, NCHW, and
what the three families share: the detect head, init, BN fold.

Counterpart of ``deal_yolo_daya_tpu/models/yolo11.py``. The top-level
submodules are named by their ultralytics ``DetectionModel.model[i]`` index
("0" ... "10", "13", "16", "17", "19", "20", "22", "23"), so the state dict
has the ultralytics keys ("0.conv.weight", "23.cv3.0.2.bias", ...). The
forward returns the raw per-level head outputs: box distributions
[(B, 64, H, W)] and class logits [(B, nc, H, W)] for strides 8/16/32.
``model.train()`` makes every BatchNorm normalise with batch statistics and
update its running ones (the JAX ``train=True``); ``model.eval()`` uses the
running ones. m, l and x use C3k inners in every C3k2.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from .blocks import (A2C2f, BN_EPS, C2PSA, C3k2, ConvBN, DWConv, SPPF, rematerialized,
                     upsample2x)

YOLO11_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

REG_MAX = 16
STRIDES = (8, 16, 32)


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def _width(c: int, width: float, max_channels: int) -> int:
    return make_divisible(min(c, max_channels) * width, 8)


def _depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per level a box branch (2x ConvBN 3x3, 1x1
    conv to 4*REG_MAX bins) and a class branch (2x [DWConv 3x3 + ConvBN 1x1],
    1x1 conv to nc logits; with ``legacy``, yolov8's 2x ConvBN 3x3 instead).
    ultralytics names: cv2[i] box, cv3[i] class."""

    def __init__(self, nc: int, ch: Sequence[int], legacy: bool = False):
        super().__init__()
        c2 = max(16, ch[0] // 4, 4 * REG_MAX)
        c3 = max(ch[0], min(nc, 100))
        self.nc = nc
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBN(c, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))
            for c in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBN(c, c3, 3), ConvBN(c3, c3, 3), nn.Conv2d(c3, nc, 1)) if legacy
            else nn.Sequential(
                nn.Sequential(DWConv(c, c, 3), ConvBN(c, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), ConvBN(c3, c3, 1)),
                nn.Conv2d(c3, nc, 1),
            )
            for c in ch
        )

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        return ([box(x) for box, x in zip(self.cv2, feats)],
                [cls(x) for cls, x in zip(self.cv3, feats)])


class Detector(nn.Module):
    """What the three families share: top-level modules named by their
    ultralytics index, ``layer(i)``, and the detect head's index ``DETECT``.

    ``remat`` (the JAX ``remat``): in a training forward that records
    gradients, the heavy blocks (``REMAT``: C3k2, SPPF, C2PSA, A2C2f and the
    head, those a family has) keep only their inputs and run again in the
    backward; the function and the parameters are the same."""

    FAMILY = ""
    SCALES: Dict[str, Tuple[float, float, int]] = {}
    DETECT = 0
    REMAT = (C3k2, SPPF, C2PSA, A2C2f, DetectHead)

    def __init__(self, nc: int, scale: str, remat: bool = False):
        super().__init__()
        if scale not in self.SCALES:
            raise ValueError(f"{self.FAMILY} scale '{scale}' not in {sorted(self.SCALES)}")
        self.nc, self.scale, self.remat = nc, scale, remat

    def block(self, i: int):
        """Module ``i`` as the forward calls it: rematerialized under
        ``remat`` in a training forward with gradients, else itself."""
        mod = self.layer(i)
        if self.remat and self.training and torch.is_grad_enabled() \
                and isinstance(mod, self.REMAT):
            return lambda *args: rematerialized(mod, *args)
        return mod

    def widths(self):
        """(w, d): the scale's channel width and block depth functions."""
        depth, width, max_ch = self.SCALES[self.scale]
        return (lambda c: _width(c, width, max_ch)), (lambda n: _depth(n, depth))

    def add_layers(self, layers: Dict[int, nn.Module]) -> None:
        for i, mod in layers.items():
            self.add_module(str(i), mod)

    def layer(self, i: int) -> nn.Module:
        return self._modules[str(i)]

    def head(self) -> "DetectHead":
        return self.layer(self.DETECT)


class YOLO11(Detector):
    """Full YOLO11 detector; forward returns per-level (box_dist, cls_logits)."""

    FAMILY = "yolo11"
    SCALES = YOLO11_SCALES
    DETECT = 23

    def __init__(self, nc: int = 80, scale: str = "n", remat: bool = False):
        super().__init__(nc, scale, remat)
        w, d = self.widths()
        c3k_all = scale in ("m", "l", "x")
        self.add_layers({
            # backbone
            0: ConvBN(3, w(64), 3, 2),                                # P1/2
            1: ConvBN(w(64), w(128), 3, 2),                           # P2/4
            2: C3k2(w(128), w(256), d(2), c3k_all, 0.25),
            3: ConvBN(w(256), w(256), 3, 2),                          # P3/8
            4: C3k2(w(256), w(512), d(2), c3k_all, 0.25),
            5: ConvBN(w(512), w(512), 3, 2),                          # P4/16
            6: C3k2(w(512), w(512), d(2), True, 0.5),
            7: ConvBN(w(512), w(1024), 3, 2),                         # P5/32
            8: C3k2(w(1024), w(1024), d(2), True, 0.5),
            9: SPPF(w(1024), w(1024), 5),
            10: C2PSA(w(1024), w(1024), d(2)),
            # head (PAN); 11/12, 14/15, 18, 21 are upsamples and concats
            13: C3k2(w(1024) + w(512), w(512), d(2), c3k_all, 0.5),
            16: C3k2(w(512) + w(512), w(256), d(2), c3k_all, 0.5),
            17: ConvBN(w(256), w(256), 3, 2),
            19: C3k2(w(256) + w(512), w(512), d(2), c3k_all, 0.5),
            20: ConvBN(w(512), w(512), 3, 2),
            22: C3k2(w(512) + w(1024), w(1024), d(2), True, 0.5),
            23: DetectHead(nc, (w(256), w(512), w(1024))),
        })

    def forward(self, x: torch.Tensor):
        m = self.block
        x = m(1)(m(0)(x))
        x = m(3)(m(2)(x))
        p3 = m(4)(x)
        p4 = m(6)(m(5)(p3))
        p5 = m(10)(m(9)(m(8)(m(7)(p4))))
        h13 = m(13)(torch.cat([upsample2x(p5), p4], 1))
        h16 = m(16)(torch.cat([upsample2x(h13), p3], 1))
        h19 = m(19)(torch.cat([m(17)(h16), h13], 1))
        h22 = m(22)(torch.cat([m(20)(h19), p5], 1))
        return m(23)((h16, h19, h22))


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: Detector, seed: int = 0) -> Detector:
    """Random init that mirrors the JAX one in distribution: lecun-normal
    conv kernels, identity BN, box bias 1.0 and the class prior
    log(5 / nc / (640 / stride)^2) (yolo12's gamma keeps its 0.01)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            _lecun_normal_(mod.weight, gen)
    head = model.head()
    for i, stride in enumerate(STRIDES):
        head.cv2[i][2].bias.fill_(1.0)
        head.cv3[i][2].bias.fill_(math.log(5 / head.nc / (640 / stride) ** 2))
    return model


def build_yolo11(scale: str = "n", nc: int = 80, seed: int = 0, device=None) -> YOLO11:
    """A randomly initialised f32 YOLO11 in eval mode on ``device`` (default
    cuda; raises when there is no card)."""
    dev = resolve_device(device)
    return init_weights(YOLO11(nc=nc, scale=scale), seed).to(dev).eval()


def bn_fold(mod: ConvBN) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv weight, bias) of a ConvBN with its BatchNorm folded in."""
    bn = mod.bn
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return mod.conv.weight * scale.view(-1, 1, 1, 1), bn.bias - bn.running_mean * scale


@torch.no_grad()
def fuse_conv_bn(model: nn.Module, input_scale: Optional[float] = None) -> nn.Module:
    """A copy of ``model`` with every BatchNorm folded into its conv (weight
    scaled, bias added, ``bn`` replaced by Identity). ``input_scale`` also
    folds an input normalisation (1/255) into the stem conv "0", so the fused
    model takes raw 0..255 images."""
    fused = copy.deepcopy(model)
    for mod in fused.modules():
        if isinstance(mod, ConvBN) and not isinstance(mod.bn, nn.Identity):
            weight, bias = bn_fold(mod)
            mod.conv.weight.copy_(weight)
            mod.conv.bias = nn.Parameter(bias)
            mod.bn = nn.Identity()
    if input_scale is not None:
        fused.layer(0).conv.weight.mul_(input_scale)
    return fused


@torch.no_grad()
def folded_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with every BatchNorm folded into its conv but
    kept under its keys, as the JAX ``fuse_conv_bn`` stores a fold: the conv
    weight scaled, ``bn.weight`` 1, ``bn.bias`` the folded bias,
    ``running_mean`` 0 and ``running_var`` 1 - eps. It loads into the plain
    detector, and folding it again changes no bit (1 / sqrt(1 - eps + eps)
    is 1 in f32)."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, mod in model.named_modules():
        if isinstance(mod, ConvBN) and not isinstance(mod.bn, nn.Identity):
            weight, bias = bn_fold(mod)
            sd.update({f"{name}.conv.weight": weight, f"{name}.bn.weight": torch.ones_like(bias),
                       f"{name}.bn.bias": bias, f"{name}.bn.running_mean": torch.zeros_like(bias),
                       f"{name}.bn.running_var": torch.ones_like(bias) - BN_EPS})
    return sd


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

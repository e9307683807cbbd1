"""YOLOv10 detection network (scales n, s, m, b, l, x) as a PyTorch module,
NCHW: the NMS-free dual-head detector.

No counterpart in the JAX package. Written from Wang et al., "YOLOv10:
Real-Time End-to-End Object Detection" (arXiv:2405.14458) and ultralytics'
``cfg/models/v10/yolov10{n,s,m,b,l,x}.yaml``: C2f stages, ``SCDown`` in place
of the stride-2 convs at P4 and P5, ``C2fCIB`` (compact inverted blocks) where
the scale places it, SPPF, one PSA attention block (``C2PSA`` at n = 1: the
same arithmetic under ``10.m.0.*`` keys where ultralytics writes ``10.attn.*``
and ``10.ffn.*``), the PAN head and ``V10DetectHead``. Top-level modules carry
the ultralytics indices 0-10, 13, 16, 17, 19, 20, 22 and detect 23.

The head has two branch sets of yolo11's design: the one-to-many set
(``cv2``/``cv3``), trained with task-aligned assignment at top-k 10, and the
one-to-one set (``one2one_cv2``/``one2one_cv3``), trained at top-k 1 on
``detach()``ed P3-P5 features, so its loss moves only its own weights. In
training the forward returns ``DualOutputs(one2many, one2one)``, each the
per-level (box_dist, cls_logits) of ``YOLO11``; in eval mode it returns the
one-to-one head's alone, which predict and validation read without NMS
(``ops/nms.py::v10_select``). At m the PSA's 288 channels make 4 heads of
head_dim 72 and key_dim 36: the attention kernels' (36, 72) build.
"""

from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .blocks import C2fCIB, C2PSA, C3k2, ConvBN, RepVGGDW, SCDown, SPPF, upsample2x
from .yolo11 import DetectHead, Detector

YOLOV10_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "b": (0.67, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

# where each scale's yaml puts C2fCIB (the rest of those slots are C2f), and
# whether its CIBs take the large-kernel RepVGGDW
CIB_AT: Dict[str, Tuple[int, ...]] = {
    "n": (22,), "s": (8, 22), "m": (8, 19, 22), "b": (8, 13, 19, 22), "l": (8, 13, 19, 22),
    "x": (6, 8, 13, 19, 22),
}
LARGE_KERNEL = ("n", "s")


class DualOutputs(NamedTuple):
    """A training forward's two heads, each (box levels, class levels)."""
    one2many: Tuple[List[torch.Tensor], List[torch.Tensor]]
    one2one: Tuple[List[torch.Tensor], List[torch.Tensor]]


class V10DetectHead(DetectHead):
    """yolo11's decoupled head plus a copy of its box and class branches,
    ``one2one_cv2``/``one2one_cv3``, fed the detached features. Training:
    ``DualOutputs``; eval: the one-to-one (box, cls) levels."""

    def __init__(self, nc: int, ch: Sequence[int]):
        super().__init__(nc, ch)
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    def one2one(self, feats: Sequence[torch.Tensor]):
        return ([box(x) for box, x in zip(self.one2one_cv2, feats)],
                [cls(x) for cls, x in zip(self.one2one_cv3, feats)])

    def forward(self, feats: Sequence[torch.Tensor]):
        if not self.training:
            return self.one2one(feats)
        return DualOutputs(super().forward(feats), self.one2one([f.detach() for f in feats]))


class YOLOv10(Detector):
    """Full YOLOv10 detector; see the module docstring."""

    FAMILY = "yolov10"
    SCALES = YOLOV10_SCALES
    DETECT = 23
    END2END = True
    REMAT = Detector.REMAT + (C2fCIB,)

    def __init__(self, nc: int = 80, scale: str = "n", remat: bool = False):
        super().__init__(nc, scale, remat)
        w, d = self.widths()
        cib, lk = CIB_AT[scale], scale in LARGE_KERNEL

        def c2f(i: int, c1: int, c2: int, n: int, shortcut: bool):
            if i in cib:
                return C2fCIB(c1, c2, n, True, lk)
            return C3k2(c1, c2, n, False, 0.5, shortcut, inner_e=1.0)

        self.add_layers({
            # backbone
            0: ConvBN(3, w(64), 3, 2),                                # P1/2
            1: ConvBN(w(64), w(128), 3, 2),                           # P2/4
            2: c2f(2, w(128), w(128), d(3), True),
            3: ConvBN(w(128), w(256), 3, 2),                          # P3/8
            4: c2f(4, w(256), w(256), d(6), True),
            5: SCDown(w(256), w(512), 3, 2),                          # P4/16
            6: c2f(6, w(512), w(512), d(6), True),
            7: SCDown(w(512), w(1024), 3, 2),                         # P5/32
            8: c2f(8, w(1024), w(1024), d(3), True),
            9: SPPF(w(1024), w(1024), 5),
            10: C2PSA(w(1024), w(1024), 1),
            # head (PAN); 11/12, 14/15, 18, 21 are upsamples and concats
            13: c2f(13, w(1024) + w(512), w(512), d(3), False),
            16: c2f(16, w(512) + w(256), w(256), d(3), False),
            17: ConvBN(w(256), w(256), 3, 2),
            19: c2f(19, w(256) + w(512), w(512), d(3), False),
            20: SCDown(w(512), w(512), 3, 2),
            22: c2f(22, w(512) + w(1024), w(1024), d(3), False),
            23: V10DetectHead(nc, (w(256), w(512), w(1024))),
        })

    def forward(self, x: torch.Tensor):
        m = self.block
        x = m(3)(m(2)(m(1)(m(0)(x))))
        p3 = m(4)(x)
        p4 = m(6)(m(5)(p3))
        p5 = m(10)(m(9)(m(8)(m(7)(p4))))
        h13 = m(13)(torch.cat([upsample2x(p5), p4], 1))
        h16 = m(16)(torch.cat([upsample2x(h13), p3], 1))
        h19 = m(19)(torch.cat([m(17)(h16), h13], 1))
        h22 = m(22)(torch.cat([m(20)(h19), p5], 1))
        return m(23)((h16, h19, h22))


def deployed_param_count(model: YOLOv10) -> int:
    """Parameters of the deployed model, as the paper counts them: the
    one-to-one head only, every BatchNorm folded into its conv (a bias of
    its width in place of its weight and bias), each RepVGGDW one 7x7 conv."""
    head = model.head()
    dropped = {id(p) for branch in (head.cv2, head.cv3) for p in branch.parameters()}
    dropped.update(id(p) for mod in model.modules() if isinstance(mod, RepVGGDW)
                   and mod.conv1 is not None for p in mod.conv1.parameters())
    with_bn = {id(mod.conv) for mod in model.modules() if isinstance(mod, ConvBN)}
    total = 0
    for mod in model.modules():
        if not isinstance(mod, torch.nn.Conv2d) or id(mod.weight) in dropped:
            continue
        w = mod.weight
        total += w.numel() + (w.shape[0] if id(mod) in with_bn or mod.bias is not None else 0)
    return total

"""YOLOv12 detection network (scales n to x) as a PyTorch module, NCHW.

Counterpart of ``deal_yolo_daya_tpu/models/yolov12.py``: C3k2 in the early
backbone, A2C2f (R-ELAN with area attention, ``blocks.AAttn``) at P4 (area
4) and P5 (area 1) and through the PAN head (C3k inners there), no
SPPF/C2PSA, and yolo11's detect head. m, l and x use C3k inners in every
C3k2; l and x add the learned gamma residual to the attention stages and
drop their MLP ratio to 1.2. Top-level modules carry the ultralytics indices
0-8, 11, 14, 15, 17, 18, 20 and detect 21; the forward returns the same
per-level head outputs as ``YOLO11``. Every attention call runs the
area-attention kernels at (key_dim, head_dim) = (32, 32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .blocks import A2C2f, C3k2, ConvBN, upsample2x
from .yolo11 import DetectHead, Detector

YOLOV12_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


class YOLOv12(Detector):
    """Full YOLOv12 detector; forward returns per-level (box_dist, cls_logits)."""

    FAMILY = "yolo12"
    SCALES = YOLOV12_SCALES
    DETECT = 21

    def __init__(self, nc: int = 80, scale: str = "n", remat: bool = False):
        super().__init__(nc, scale, remat)
        w, d = self.widths()
        c3k_all = scale in ("m", "l", "x")
        res = scale in ("l", "x")       # gamma residual on the attention stages
        mlp = 1.2 if res else 2.0

        def a2c2f(c1: int, c2: int, n: int, a2: bool, area: int) -> A2C2f:
            return A2C2f(c1, c2, n, a2, area, residual=res, mlp_ratio=mlp)

        self.add_layers({
            # backbone
            0: ConvBN(3, w(64), 3, 2),                                # P1/2
            1: ConvBN(w(64), w(128), 3, 2),                           # P2/4
            2: C3k2(w(128), w(256), d(2), c3k_all, 0.25),
            3: ConvBN(w(256), w(256), 3, 2),                          # P3/8
            4: C3k2(w(256), w(512), d(2), c3k_all, 0.25),
            5: ConvBN(w(512), w(512), 3, 2),                          # P4/16
            6: a2c2f(w(512), w(512), d(4), True, 4),
            7: ConvBN(w(512), w(1024), 3, 2),                         # P5/32
            8: a2c2f(w(1024), w(1024), d(4), True, 1),
            # head (PAN); 9/10, 12/13, 16, 19 are upsamples and concats
            11: a2c2f(w(1024) + w(512), w(512), d(2), False, 1),
            14: a2c2f(w(512) + w(512), w(256), d(2), False, 1),
            15: ConvBN(w(256), w(256), 3, 2),
            17: a2c2f(w(256) + w(512), w(512), d(2), False, 1),
            18: ConvBN(w(512), w(512), 3, 2),
            20: C3k2(w(512) + w(1024), w(1024), d(2), True, 0.5),
            21: DetectHead(nc, (w(256), w(512), w(1024))),
        })

    def forward(self, x: torch.Tensor):
        m = self.block
        x = m(3)(m(2)(m(1)(m(0)(x))))
        p3 = m(4)(x)
        p4 = m(6)(m(5)(p3))
        p5 = m(8)(m(7)(p4))
        h11 = m(11)(torch.cat([upsample2x(p5), p4], 1))
        h14 = m(14)(torch.cat([upsample2x(h11), p3], 1))
        h17 = m(17)(torch.cat([m(15)(h14), h11], 1))
        h20 = m(20)(torch.cat([m(18)(h17), p5], 1))
        return m(21)((h14, h17, h20))

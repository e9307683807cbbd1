"""YOLOv8 detection network (scales n to x) as a PyTorch module, NCHW.

Counterpart of ``deal_yolo_daya_tpu/models/yolov8.py``: C2f stages (C3k2
with plain Bottleneck inners of expansion 1.0, the same CSP), SPPF, the PAN
head and the legacy detect head (plain 3x3 convs in the class branch); no
attention. Top-level modules carry the ultralytics indices 0-9, 12, 15, 16,
18, 19, 21 and detect 22; the forward returns the same per-level head
outputs as ``YOLO11``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .blocks import C3k2, ConvBN, SPPF, upsample2x
from .yolo11 import DetectHead, Detector

YOLOV8_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}


class YOLOv8(Detector):
    """Full YOLOv8 detector; forward returns per-level (box_dist, cls_logits)."""

    FAMILY = "yolov8"
    SCALES = YOLOV8_SCALES
    DETECT = 22

    def __init__(self, nc: int = 80, scale: str = "n", remat: bool = False):
        super().__init__(nc, scale, remat)
        w, d = self.widths()

        def c2f(c1: int, c2: int, n: int, shortcut: bool) -> C3k2:
            return C3k2(c1, c2, n, False, 0.5, shortcut, inner_e=1.0)

        self.add_layers({
            # backbone
            0: ConvBN(3, w(64), 3, 2),                                # P1/2
            1: ConvBN(w(64), w(128), 3, 2),                           # P2/4
            2: c2f(w(128), w(128), d(3), True),
            3: ConvBN(w(128), w(256), 3, 2),                          # P3/8
            4: c2f(w(256), w(256), d(6), True),
            5: ConvBN(w(256), w(512), 3, 2),                          # P4/16
            6: c2f(w(512), w(512), d(6), True),
            7: ConvBN(w(512), w(1024), 3, 2),                         # P5/32
            8: c2f(w(1024), w(1024), d(3), True),
            9: SPPF(w(1024), w(1024), 5),
            # head (PAN); 10/11, 13/14, 17, 20 are upsamples and concats
            12: c2f(w(1024) + w(512), w(512), d(3), False),
            15: c2f(w(512) + w(256), w(256), d(3), False),
            16: ConvBN(w(256), w(256), 3, 2),
            18: c2f(w(256) + w(512), w(512), d(3), False),
            19: ConvBN(w(512), w(512), 3, 2),
            21: c2f(w(512) + w(1024), w(1024), d(3), False),
            22: DetectHead(nc, (w(256), w(512), w(1024)), legacy=True),
        })

    def forward(self, x: torch.Tensor):
        m = self.block
        x = m(3)(m(2)(m(1)(m(0)(x))))
        p3 = m(4)(x)
        p4 = m(6)(m(5)(p3))
        p5 = m(9)(m(8)(m(7)(p4)))
        h12 = m(12)(torch.cat([upsample2x(p5), p4], 1))
        h15 = m(15)(torch.cat([upsample2x(h12), p3], 1))
        h18 = m(18)(torch.cat([m(16)(h15), h12], 1))
        h21 = m(21)(torch.cat([m(19)(h18), p5], 1))
        return m(22)((h15, h18, h21))

"""Weight carry-over from the JAX package's parameter tree.

The port's copy of the key map in ``deal_yolo_daya_tpu/models/torch_import.py``
(yolo11 only): the JAX ``{"params", "batch_stats"}`` tree, as nested dicts of
numpy arrays, becomes a state dict with the ultralytics ``DetectionModel``
keys that ``models/yolo11.py`` uses. Conv kernels go from HWIO to OIHW; a
depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3). The JAX package's
``export_state_dict`` output has the same keys and layout, so either loads
with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

# JAX top-level module -> ultralytics DetectionModel.model index (yolo11)
TOP_MODULES: Dict[str, int] = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
    "b7": 7, "b8": 8, "b9": 9, "b10": 10,
    "h13": 13, "h16": 16, "h17": 17, "h19": 19, "h20": 20, "h22": 22,
    "detect": 23,
}

# JAX leaf name -> ultralytics leaf name
_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _translate_segment(seg: str, in_detect: bool) -> List[str]:
    """One segment of a JAX module path -> ultralytics segments."""
    if in_detect:
        m = re.fullmatch(r"box(\d)_(\d)", seg)
        if m:  # box branch: cv2[i] = (Conv, Conv, Conv2d)
            return ["cv2", m.group(1), m.group(2)]
        m = re.fullmatch(r"cls(\d)_(\d)(dw|pw)", seg)
        if m:  # class branch: cv3[i] = (Seq(DWConv, Conv), Seq(DWConv, Conv), Conv2d)
            return ["cv3", m.group(1), m.group(2), "0" if m.group(3) == "dw" else "1"]
        m = re.fullmatch(r"cls(\d)_(\d)", seg)
        if m:
            return ["cv3", m.group(1), m.group(2)]
    if seg == "dw":  # the JAX DWConv wraps a ConvBN named "dw"; here DWConv is the ConvBN
        return []
    m = re.fullmatch(r"(m|ffn)(\d+)", seg)
    if m:  # m{i} / ffn{i} -> ModuleList / Sequential index
        return [m.group(1), m.group(2)]
    return [seg]


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> the port's float32 state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, segs, in_detect):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, segs + _translate_segment(k, in_detect), in_detect)
                continue
            arr = np.array(v, np.float32)  # a writable copy
            if k == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[".".join(segs + [_LEAF[k]])] = torch.from_numpy(np.ascontiguousarray(arr))

    for coll in ("params", "batch_stats"):
        for top, sub in (variables.get(coll) or {}).items():
            if top not in TOP_MODULES:
                raise KeyError(f"{coll}/{top}: not a yolo11 module")
            walk(sub, [str(TOP_MODULES[top])], top == "detect")
    return out

"""Weight carry-over from the JAX package's parameter tree.

The port's copy of the key map in ``deal_yolo_daya_tpu/models/torch_import.py``
for the three families: the JAX ``{"params", "batch_stats"}`` tree, as nested
dicts of numpy arrays, becomes a state dict with the ultralytics
``DetectionModel`` keys that ``models/yolo11.py``, ``yolov8.py`` and
``yolov12.py`` use. The family comes from the tree, as the JAX
``ultralytics_key_map`` finds it: yolo12's head starts at ``h11``, yolo11 has
the C2PSA stage ``b10``, anything else is yolov8. Conv kernels go from HWIO to
OIHW; a depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3). The JAX package's
``export_state_dict`` output has the same keys and layout, so either loads
with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

# JAX top-level module -> ultralytics DetectionModel.model index, a family each
TOP_MODULES_BY_FAMILY: Dict[str, Dict[str, int]] = {
    "yolo11": {
        "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
        "b7": 7, "b8": 8, "b9": 9, "b10": 10,
        "h13": 13, "h16": 16, "h17": 17, "h19": 19, "h20": 20, "h22": 22,
        "detect": 23,
    },
    "yolov8": {
        "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
        "b7": 7, "b8": 8, "b9": 9,
        "h12": 12, "h15": 15, "h16": 16, "h18": 18, "h19": 19, "h21": 21,
        "detect": 22,
    },
    "yolo12": {
        "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
        "b7": 7, "b8": 8,
        "h11": 11, "h14": 14, "h15": 15, "h17": 17, "h18": 18, "h20": 20,
        "detect": 21,
    },
}

# JAX leaf name -> ultralytics leaf name
_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "gamma": "gamma",  # yolo12 l/x A2C2f residual scale
}


def family_of_tree(tree: Dict[str, Any]) -> str:
    """The family of a JAX parameter (or batch_stats) tree, by its top-level
    module names."""
    if "h11" in tree:
        return "yolo12"
    if "b10" in tree:
        return "yolo11"
    return "yolov8"


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
    m = re.fullmatch(r"m(\d+)_blk(\d+)", seg)
    if m:  # A2C2f: ABlock j of inner Sequential i -> m.{i}.{j}
        return ["m", m.group(1), m.group(2)]
    m = re.fullmatch(r"(m|ffn|mlp)(\d+)", seg)
    if m:  # m{i} / ffn{i} / mlp{i} -> ModuleList / Sequential index
        return [m.group(1), m.group(2)]
    return [seg]


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree of any family -> the port's
    float32 state dict."""
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

    family = family_of_tree(variables.get("params") or variables.get("batch_stats") or {})
    top_modules = TOP_MODULES_BY_FAMILY[family]
    for coll in ("params", "batch_stats"):
        for top, sub in (variables.get(coll) or {}).items():
            if top not in top_modules:
                raise KeyError(f"{coll}/{top}: not a {family} module")
            walk(sub, [str(top_modules[top])], top == "detect")
    return out


def qtree_from_jax(qtree: Dict[Any, Dict[str, Any]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's int8 qtree (flax module paths, as tuples or
    "/"-joined as its bundles store them, -> {w_int8 HWIO, w_scale, a_scale})
    -> the port's (``models/quant.py``): ultralytics module names ("1.conv",
    "23.cv3.0.0.1.conv", ...) -> {w_int8 OIHW int8, w_scale f32, a_scale f32}."""
    paths = {k if isinstance(k, tuple) else tuple(k.split("/")): v for k, v in qtree.items()}
    top_modules = TOP_MODULES_BY_FAMILY[family_of_tree({p[0]: None for p in paths})]
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, q in paths.items():
        segs = [str(top_modules[path[0]])]
        for seg in path[1:]:
            segs += _translate_segment(seg, path[0] == "detect")
        w = np.array(q["w_int8"], np.int8).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join(segs)] = {
            "w_int8": torch.from_numpy(np.ascontiguousarray(w)),
            "w_scale": torch.from_numpy(np.array(q["w_scale"], np.float32)),
            "a_scale": torch.tensor(np.float32(q["a_scale"])),
        }
    return out

"""Model-family registry: a spec string or a state dict -> the detector.

Counterpart of ``deal_yolo_daya_tpu/models/registry.py`` (and of
``torch_import.infer_arch`` for ultralytics keys). The families are YOLO11
(the default), YOLOv8 and YOLOv12, which give the same per-level head
outputs, so decode, NMS, the loss, the Trainer and predict take any of them,
and YOLOv10 (no JAX counterpart), whose two heads the loss, predict and
validation take by their own paths (``train/loss.py::dual_detection_loss``,
``ops/nms.py::v10_select``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple, Type

from ..device import resolve_device
from .yolo11 import Detector, YOLO11, init_weights
from .yolov8 import YOLOv8
from .yolov10 import YOLOv10
from .yolov12 import YOLOv12

FAMILIES: Dict[str, Type[Detector]] = {"yolo11": YOLO11, "yolov8": YOLOv8, "yolo12": YOLOv12,
                                       "yolov10": YOLOv10}


def parse_model_spec(model: str) -> Tuple[str, str]:
    """'yolo11n' | 'yolov8s.yaml' | '.../yolo12x.yaml' | 'yolov10b' | 'm' ->
    (family, scale). Unknown specs default to ('yolo11', 'n'), as in the JAX
    package. YOLOv10 ('yolov10' or 'yolo10') adds the scale b."""
    stem = Path(str(model)).stem.lower()
    if "yolov12" in stem or "yolo12" in stem:
        family = "yolo12"
    elif "yolov10" in stem or "yolo10" in stem:
        family = "yolov10"
    elif "yolov8" in stem or "yolo8" in stem:
        family = "yolov8"
    else:
        family = "yolo11"
    if stem in set("nsmlx"):  # a bare scale letter (the default family)
        return family, stem
    if "yolo" in stem:  # a scale letter is trusted only on a yolo-looking spec
        for s in FAMILIES[family].SCALES:
            if stem.endswith(s):
                return family, s
    return family, "n"


def end_to_end(family: str) -> bool:
    """Whether ``family``'s detectors are end to end (``Detector.END2END``)."""
    return FAMILIES[family].END2END


def make_detector(family: str, scale: str, nc: int = 80, remat: bool = False) -> Detector:
    """The uninitialised detector module of a family and scale (on the
    current default device, so ``torch.device("meta")`` builds it
    shapes-only); ``remat`` recomputes its heavy blocks in the backward."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}: one of {sorted(FAMILIES)}")
    return FAMILIES[family](nc=nc, scale=scale, remat=remat)


def build_detector(spec: str = "yolo11n", nc: int = 80, seed: int = 0,
                   device=None) -> Detector:
    """A randomly initialised f32 detector of any family in eval mode on
    ``device`` (default cuda; raises when there is no card)."""
    dev = resolve_device(device)
    family, scale = parse_model_spec(spec)
    return init_weights(make_detector(family, scale, nc), seed).to(dev).eval()


def _module_key(key: str) -> str:
    """A state-dict key from its first numeric segment ('model.0.conv.weight'
    -> '0.conv.weight'), as ultralytics' wrappers prefix them."""
    segs = key.split(".")
    first = next((i for i, seg in enumerate(segs) if seg.isdigit()), 0)
    return ".".join(segs[first:])


def infer_arch(state_dict: Mapping[str, object]) -> Tuple[str, str]:
    """(family, scale) of a state dict with the ultralytics keys: the detect
    head's index gives the family (yolo11 23, yolov8 22, yolo12 21), and at
    index 23 a one-to-one branch (``23.one2one_cv2.*``) makes it yolov10; the
    stem width gives the scale, and where two scales share widths
    (yolo11/yolo12 m and l, yolov10 b and l) the depth of module 2."""
    sd = {_module_key(k): v for k, v in state_dict.items()}
    family = next((f for f, cls in FAMILIES.items() if f"{cls.DETECT}.cv3.0.2.bias" in sd), None)
    if family is None or "0.conv.weight" not in sd:
        raise ValueError("not a YOLO11/YOLOv8/YOLOv12 detection state dict, nor a YOLOv10 "
                         "one (no stem conv, or no detect class bias at module index 21, 22 "
                         "or 23)")
    if family == "yolo11" and "23.one2one_cv2.0.2.bias" in sd:
        family = "yolov10"
    stem = int(sd["0.conv.weight"].shape[0])
    if family == "yolov8":
        by_stem = {16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}
    elif family == "yolov10":
        by_stem = {16: "n", 32: "s", 48: "m", 80: "x",
                   64: "l" if "2.m.2.cv1.conv.weight" in sd else "b"}
    else:  # yolo11 and yolo12 share the width and depth table
        by_stem = {16: "n", 32: "s", 96: "x", 64: "l" if "2.m.1.cv1.conv.weight" in sd else "m"}
    if stem not in by_stem:
        raise ValueError(f"unrecognized {family} stem width {stem}")
    return family, by_stem[stem]

"""The YOLO11, YOLOv8 and YOLOv12 network modules, the family registry, init,
BN fold and weight carry-over."""

from .registry import FAMILIES, build_detector, infer_arch, make_detector, parse_model_spec  # noqa: F401
from .weights import state_dict_from_jax  # noqa: F401
from .yolo11 import YOLO11, build_yolo11, fuse_conv_bn, param_count  # noqa: F401
from .yolov8 import YOLOv8  # noqa: F401
from .yolov12 import YOLOv12  # noqa: F401

"""YOLO11 network modules, init, BN fold and weight carry-over."""

from .yolo11 import YOLO11, build_yolo11, fuse_conv_bn, param_count  # noqa: F401
from .weights import state_dict_from_jax  # noqa: F401

"""PyTorch and CUDA port of deal_yolo_daya_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports neither
JAX nor anything of it. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

from .api import YOLO, Detections  # noqa: F401
from .models.yolo11 import build_yolo11  # noqa: F401

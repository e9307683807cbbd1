"""PyTorch and CUDA port of deal_yolo_daya_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports neither
JAX nor anything of it. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.

``YOLO``, ``Detections`` and ``build_yolo11`` load on first use, so that a
process that only runs an exported program with kernels imports
``ops.kernels`` (where the custom ops are registered) and no model class.
"""

_LAZY = {"YOLO": "api", "Detections": "api", "build_yolo11": "models.yolo11"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

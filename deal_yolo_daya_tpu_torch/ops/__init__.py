"""Box geometry, decode, NMS and letterbox on torch tensors."""

from .letterbox import letterbox_batch, letterbox_params  # noqa: F401

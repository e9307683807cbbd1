"""Per-anchor score reduction: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the TPU kernel ``deal_yolo_daya_tpu/ops/pallas/score_reduce.py::_kernel``:
(B, A, nc) class logits in bf16 or f32 -> (sigmoid of the max in f32, the
first class reaching the max as int32), each (B, A).

What bounds it on an H100: bytes, about one operation a byte read.
``csrc/score_reduce.cu`` reads the logits in place by their strides (a
``.contiguous()`` copy would move more bytes than the kernel): one warp a row
when the classes are contiguous, one thread an anchor otherwise. The score
is computed with torch.sigmoid's CUDA formula, so the kernel's outputs can
equal the plain version's bit for bit.

No path calls it yet, as in the JAX package: ``ops/nms.py`` reduces the
sigmoid scores with ``amax``/``argmax``. On logits, a larger logit wins where
two sigmoids round to the same f32 (above ~16.6 both are 1.0); on sigmoid
scores the lower class wins. The max score is the same either way.

``score_reduce`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launches = 0


def score_reduce_plain(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``score_reduce_xla``: (B, A, nc) -> (B, A) f32
    sigmoid(max), (B, A) int32 argmax (first index on ties)."""
    x = logits.float()
    return torch.sigmoid(x.amax(-1)), x.argmax(-1).to(torch.int32)


def score_reduce(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, A, nc) bf16 or f32 logits, any strides -> (score (B, A) f32,
    class (B, A) int32)."""
    if logits.device.type == "cpu":
        return score_reduce_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"score_reduce: no kernel for device {logits.device}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"score_reduce: logits {logits.dtype} (bfloat16 / float32)")
    if logits.dim() != 3 or 0 in logits.shape:
        raise ValueError(f"score_reduce: logits {tuple(logits.shape)}, (B, A, nc) non-empty")
    b, a, nc = logits.shape
    score = torch.empty((b, a), dtype=torch.float32, device=logits.device)
    cls = torch.empty((b, a), dtype=torch.int32, device=logits.device)
    fn = _build.load("score_reduce").score_reduce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    sb, sa, sc = logits.stride()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), int(logits.dtype == torch.bfloat16), b, a, nc, sb, sa, sc,
                 score.data_ptr(), cls.data_ptr(), stream)
    _build.check(err, "score_reduce launch")
    global launches
    launches += 1
    return score, cls

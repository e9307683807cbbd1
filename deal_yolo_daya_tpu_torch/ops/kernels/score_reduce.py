"""Per-anchor score reduction: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the TPU kernel ``deal_yolo_daya_tpu/ops/pallas/score_reduce.py::_kernel``:
(B, A, nc) class logits in bf16 or f32 -> (sigmoid of the max in f32, the
first class reaching the max as int32), each (B, A).

What bounds it on an H100: bytes, about one operation a byte read.
``csrc/score_reduce.cu`` reads the logits in place by their strides (a
``.contiguous()`` copy would move more bytes than the kernel), by the mapping
that ``reduce_mapping`` picks from the layout: 256-row tiles by 1-D bulk copy
(TMA) into a double-buffered ring, one thread a row from shared memory
(``bulk_rows``: the (B, A, nc) rows back to back, a whole number of 16-byte
vectors each from a 16-byte boundary, as decode makes them at nc 80); one
warp a row for other class-contiguous rows (``warp_rows``: odd widths, a view
off a 16-byte boundary, rows with gaps); one thread an anchor for other
strides (``anchors``). The score is computed with torch.sigmoid's CUDA
formula, so the kernel's outputs can equal the plain version's bit for bit.

No path calls it yet, as in the JAX package: ``ops/nms.py`` reduces the
sigmoid scores with ``amax``/``argmax``. On logits, a larger logit wins where
two sigmoids round to the same f32 (above ~16.6 both are 1.0); on sigmoid
scores the lower class wins. The max score is the same either way.

``score_reduce`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts the kernel launches, a CUDA
graph's at each replay (``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build

launches = 0

# the kernel's mappings (csrc/score_reduce.cu: Mapping)
MAPPINGS = {"anchors": 0, "warp_rows": 1, "bulk_rows": 2}
BULK_TILE = 256      # rows a bulk tile (csrc/score_reduce.cu)
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int] + \
    [ctypes.c_longlong] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3


def reduce_mapping(dtype: torch.dtype, shape: Sequence[int], strides: Sequence[int],
                   data_ptr: int) -> str:
    """The kernel's mapping for (B, A, nc) logits of this dtype, shape,
    element strides and address: ``anchors`` unless the classes are
    contiguous; then ``bulk_rows`` where the rows lie back to back from a
    16-byte boundary, each a whole number of 16-byte vectors, and two
    256-row tiles fit a block's shared memory; else ``warp_rows``."""
    b, a, nc = shape
    sb, sa, sc = strides
    if sc != 1:
        return "anchors"
    esize = 2 if dtype == torch.bfloat16 else 4
    bulk = ((a == 1 or sa == nc) and (b == 1 or sb == a * nc) and (nc * esize) % 16 == 0
            and data_ptr % 16 == 0 and 2 * BULK_TILE * nc * esize + 16 <= SMEM_LIMIT)
    return "bulk_rows" if bulk else "warp_rows"


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
    return launch(logits)


def launch(logits: torch.Tensor, mapping: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch behind ``score_reduce`` for a CUDA tensor, by
    ``reduce_mapping``'s choice unless ``mapping`` names another (the kernel
    refuses one the layout does not allow)."""
    if logits.device.type != "cuda":
        raise ValueError(f"score_reduce: no kernel for device {logits.device}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"score_reduce: logits {logits.dtype} (bfloat16 / float32)")
    if logits.dim() != 3 or 0 in logits.shape:
        raise ValueError(f"score_reduce: logits {tuple(logits.shape)}, (B, A, nc) non-empty")
    b, a, nc = logits.shape
    sb, sa, sc = logits.stride()
    mapping = mapping or reduce_mapping(logits.dtype, logits.shape, logits.stride(),
                                        logits.data_ptr())
    score = torch.empty((b, a), dtype=torch.float32, device=logits.device)
    cls = torch.empty((b, a), dtype=torch.int32, device=logits.device)
    fn = _build.function("score_reduce", "score_reduce", _ARGS)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), int(logits.dtype == torch.bfloat16), b, a, nc, sb, sa, sc,
                 MAPPINGS[mapping], score.data_ptr(), cls.data_ptr(), stream)
    _build.check(err, f"score_reduce launch ({mapping})")
    _build.count_launch(__name__)
    return score, cls

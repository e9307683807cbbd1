"""NMS suppression: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``deal_yolo_daya_tpu/ops/pallas/nms_suppress.py::_kernel``.
Given score-sorted, class-offset candidate boxes and their validity, it
returns the exact greedy keep mask

    keep_i = valid_i and not any(j < i: keep_j and IoU(j, i) > thr)

with IoU in f32 and eps 1e-7, batched over images.

What bounds it on an H100: the ~K^2/2 f32 IoU evaluations and the scan that
follows them, which is sequential by nature; the inputs are only 16 KB of
boxes an image. ``csrc/nms_suppress.cu`` builds the K x K suppression
bitmask over many blocks into a scratch buffer, then walks each image's
bitmask with one warp from shared memory. The keep mask is bit-identical to
the plain version's: every IoU operation is correctly rounded and never
contracted, in the plain version's order.

``nms_suppress`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..boxes import bbox_iou
from . import _build

launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use


def nms_suppress_plain(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float) -> torch.Tensor:
    """The suppression solve of ``deal_yolo_daya_tpu/ops/nms.py`` (the XLA
    path the TPU kernel is held to): the K x K suppression matrix, then
    Jacobi iteration to the greedy fixed point, for every image at once."""
    k = boxes.shape[1]
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    # sup[b, j, i]: candidate j (higher score) suppresses candidate i
    before = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    boxes = boxes.float()
    iou = bbox_iou(boxes[:, :, None, :], boxes[:, None, :, :])  # [b, j, i], the kernel's op order
    sup = (iou > thr) & before & valid[:, :, None] & valid[:, None, :]
    prev = valid
    keep = valid & ~sup.any(1)
    for _ in range(k):
        if torch.equal(keep, prev):
            break
        prev, keep = keep, valid & ~(sup & keep[:, :, None]).any(1)
    return keep


def nms_suppress(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    """boxes (B, K, 4) f32 xyxy, score-descending; valid (B, K) bool
    -> keep (B, K) bool."""
    if boxes.device.type == "cpu":
        return nms_suppress_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_suppress: no kernel for device {boxes.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"nms_suppress: boxes {boxes.dtype} / valid {valid.dtype} "
                         "(float32 / bool)")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"nms_suppress: boxes {tuple(boxes.shape)}, valid "
                         f"{tuple(valid.shape)} (B, K, 4) and (B, K)")
    if valid.device != boxes.device:
        raise ValueError("nms_suppress: boxes and valid on different devices")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_suppress: inputs must be contiguous")
    b, k, _ = boxes.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _build.load("nms_suppress")
    lib.nms_suppress_smem_bytes.argtypes = [ctypes.c_int]
    lib.nms_suppress_smem_bytes.restype = ctypes.c_longlong
    if lib.nms_suppress_smem_bytes(k) > SMEM_LIMIT:
        raise ValueError(f"nms_suppress: K={k} candidates exceed a block's shared memory")
    lib.nms_suppress_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nms_suppress_scratch_words.restype = ctypes.c_longlong
    scratch = torch.empty(lib.nms_suppress_scratch_words(b, k), dtype=torch.int32,
                          device=boxes.device)  # the (B, K, ceil(K/32)) suppression bitmask
    fn = lib.nms_suppress
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(), keep.data_ptr(),
                 b, k, float(iou_thres), stream)
    _build.check(err, "nms_suppress launch")
    global launches
    launches += 1
    return keep

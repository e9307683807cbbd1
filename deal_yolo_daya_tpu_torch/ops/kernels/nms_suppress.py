"""NMS suppression: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``deal_yolo_daya_tpu/ops/pallas/nms_suppress.py::_kernel``.
Given score-sorted, class-offset candidate boxes and their validity, it
returns the exact greedy keep mask

    keep_i = valid_i and not any(j < i: keep_j and IoU(j, i) > thr)

with IoU in f32 and eps 1e-7, batched over images.

What bounds it on an H100: the ~K^2/2 pair tests, f32 work on the CUDA
cores, and a walk over the K x ceil(K/32) suppression bitmask that is
sequential by nature; the inputs are only 16 KB of boxes an image.
``csrc/nms_suppress.cu`` is one launch with no global scratch: a
thread-block cluster an image, whose warps share the bitmask's upper
triangle in equal units. A cheap necessary test (centre distance against
(1 - iou) of the half widths, with slack) picks the pairs that may pass;
only those get the exact IoU. Each unit's words go straight into the walking
CTA's shared memory (``st.async`` onto a row tile's mbarrier), and that CTA
walks them a 32-bit word at a time as the row tiles arrive, overlapped with
the rest of the mask. ``nms_geometry`` picks the cluster size (the largest
of which the card runs all B at once), whether the walking CTA computes too,
and the shared memory bytes, from the counts of clusters the card holds at
once (``active_clusters``, read from the card once). Beyond ``MAX_K`` = 1344
candidates the walking CTA cannot hold the bitmask, and the geometry picks
the global-memory mapping: the same unit deal writes the bitmask into device
memory (allocated here), and one warp an image walks it there. The keep
mask is bit-identical to the plain version's in either mapping: every IoU
that decides a bit is correctly rounded and never contracted, in the plain
version's order.

The IoU threshold reaches the kernel as one f32 in device memory, as the
TPU kernel reads it from SMEM: a float becomes a 0-dim tensor by
``torch.full`` on the boxes' device, a fill kernel that a CUDA graph
captures and replays (a copy from the host would break the capture), and a
0-dim f32 tensor on that device is read where it lies, so an exported
program's runtime ``iou`` input, or a graph replayed after that tensor is
refilled, changes the threshold without a host read.

The kernel is the custom op ``dyd::nms_suppress(boxes, valid, iou) ->
keep`` (``torch.library``): its CUDA implementation is ``launch``, its CPU
implementation the plain version, and its fake implementation gives
``torch.export`` the output's shape, so an exported program holds the op.
``nms_suppress`` takes the plain version for CPU tensors (a trace on the CPU
holds only aten ops) and the op for CUDA tensors; ``launches`` counts the
kernel launches, a CUDA graph's at each replay (``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from ..boxes import bbox_iou
from . import _build

launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use
SMS = 132            # an H100's SMs
MAX_CLUSTER = 8      # the portable cluster size
HEAD_BYTES = 512     # the walking CTA's row-tile mbarriers (csrc/nms_suppress.cu)
SCRATCH_BYTES = 4096  # a computing CTA's candidate and hit words, 32 a warp
PAD = 32             # boxes staged past K (csrc/nms_suppress.cu)
# clusters of each size (index) that one H100 SXM held at once at one CTA an
# SM (cudaOccupancyMaxActiveClusters, measured): its GPCs do not split into
# equal clusters, so 132 // C overstates it from C = 3. The tests pass it to
# nms_geometry; a launch passes the card's own counts (active_clusters)
ACTIVE_CLUSTERS = (0, 132, 66, 39, 30, 22, 17, 15, 15)
G_THREADS = 256      # threads of a global-mapping mask CTA (csrc/nms_suppress.cu)

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
_GLOBAL_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]
_ACTIVE: Dict[int, Tuple[int, ...]] = {}  # the card's counts, by device index


class NmsGeometry(NamedTuple):
    """One launch's shape. The cluster mapping (``blocks`` 0): ``cluster``
    CTAs an image; ``first`` is the first rank that computes mask units (0:
    the walking CTA too; 1: only its peers); ``smem`` the dynamic shared
    memory bytes of every CTA. The global-memory mapping (K > MAX_K):
    ``blocks`` mask CTAs an image, ``smem`` the walking warp's bytes,
    ``cluster`` 1 and ``first`` 0."""
    cluster: int
    first: int
    smem: int
    blocks: int = 0

    @property
    def in_global(self) -> bool:
        """Whether the bitmask lives in device memory (K > MAX_K)."""
        return self.blocks > 0


def walker_bytes(k: int) -> int:
    """The walking CTA's shared memory: header, the K x ceil(K/32) u32
    bitmask and the K validity bytes."""
    return HEAD_BYTES + 4 * k * ((k + 31) // 32) + k


MAX_K = max(k for k in range(1, 2049) if walker_bytes(k) <= SMEM_LIMIT)  # 1344


def bitmask_words(b: int, k: int) -> int:
    """u32 words of the global mapping's bitmask: K x ceil(K/32) an image."""
    return b * k * ((k + 31) // 32)


def nms_geometry(b: int, k: int, active: Sequence[int]) -> NmsGeometry:
    """The launch geometry for B images of K candidates on a card that holds
    ``active[c]`` clusters of c CTAs at once (``active_clusters()``, or
    ``ACTIVE_CLUSTERS``). K <= MAX_K takes the cluster mapping, a larger K the
    global-memory one; raises ValueError for K < 1."""
    if k < 1:
        raise ValueError(f"nms_suppress: K={k} candidates (at least 1)")
    if k > MAX_K:  # enough mask CTAs for ~4 an SM over the batch, no more than units
        words = (k + 31) // 32
        warps = G_THREADS // 32
        units = words * (words + 1) // 2
        blocks = max(1, min(-(-units // warps), -(-4 * SMS // b)))
        walk = 4 * words
        if walk > SMEM_LIMIT:
            raise ValueError(f"nms_suppress: K={k} candidates exceed the walk's shared memory")
        return NmsGeometry(1, 0, walk, blocks)
    boxes_at = (walker_bytes(k) + 15) // 16 * 16
    held = 16 * (k + PAD) + SCRATCH_BYTES  # the staged boxes and the warps' words
    if boxes_at + held <= SMEM_LIMIT:    # the walking CTA holds the boxes too
        first, smem = 0, boxes_at + held
    else:                                # peers hold them and the validity
        first, smem = 1, max(walker_bytes(k), held + k)
    # the largest cluster whose B copies all run at once, else the smallest
    fits = [c for c in range(first + 1, MAX_CLUSTER + 1) if b <= active[c]]
    return NmsGeometry(max(fits) if fits else first + 1, first, smem)


def max_active_clusters(geometry: NmsGeometry) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the geometry on the current card."""
    fn = _build.function("nms_suppress", "nms_suppress_max_active_clusters",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    _build.check(fn(geometry.cluster, geometry.smem, ctypes.addressof(out)),
                 "nms_suppress occupancy")
    return out.value


def active_clusters(device: Optional[torch.device] = None) -> Tuple[int, ...]:
    """The current card's ``active[c]``: how many clusters of c CTAs of the
    kernel (one CTA an SM, the largest shared memory) it holds at once, for
    c = 1..MAX_CLUSTER; read once a device and cached."""
    index = torch.cuda.current_device() if device is None or device.index is None \
        else device.index
    counts = _ACTIVE.get(index)
    if counts is None:
        with torch.cuda.device(index):
            counts = (0,) + tuple(max_active_clusters(NmsGeometry(c, 0, SMEM_LIMIT))
                                  for c in range(1, MAX_CLUSTER + 1))
        _ACTIVE[index] = counts
    return counts


Threshold = Union[float, torch.Tensor]


def _jacobi_continues(step, prev, keep, sup, valid):
    """The fixed point is not reached and fewer than K updates ran."""
    return (step < sup.shape[1]) & (keep != prev).any()


def _jacobi_step(step, prev, keep, sup, valid):
    """One Jacobi update of every image's keep mask."""
    return step + 1, keep.clone(), valid & ~(sup & keep[:, :, None]).any(1)


def nms_suppress_plain(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: Threshold) -> torch.Tensor:
    """The suppression solve of ``deal_yolo_daya_tpu/ops/nms.py`` (the XLA
    path the TPU kernel is held to): the K x K suppression matrix, then
    Jacobi iteration to the greedy fixed point, for every image at once,
    in the ``while_loop`` higher-order op (JAX's ``lax.while_loop``): a
    Python loop when run eagerly, one node when ``torch.export`` traces it,
    never a host read at trace time. ``iou_thres`` is a float (rounded to
    f32) or a 0-dim f32 tensor, compared as it is."""
    k = boxes.shape[1]
    thr = torch.as_tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    # sup[b, j, i]: candidate j (higher score) suppresses candidate i
    before = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    boxes = boxes.float()
    iou = bbox_iou(boxes[:, :, None, :], boxes[:, None, :, :])  # [b, j, i], the kernel's op order
    sup = (iou > thr) & before & valid[:, :, None] & valid[:, None, :]
    step = torch.zeros((), dtype=torch.int64, device=boxes.device)
    _, _, keep = while_loop_op(_jacobi_continues, _jacobi_step,
                               (step, valid.clone(), valid & ~sup.any(1)), (sup, valid))
    return keep


def threshold_tensor(iou_thres: Threshold, device: torch.device) -> torch.Tensor:
    """The threshold as the kernel reads it: a 0-dim f32 tensor on ``device``.
    A float is filled in on the device (a kernel, which a CUDA graph
    captures); a tensor must already be one f32 there."""
    if not isinstance(iou_thres, torch.Tensor):
        return torch.full((), float(iou_thres), dtype=torch.float32, device=device)
    if iou_thres.dtype != torch.float32 or iou_thres.numel() != 1 \
            or iou_thres.device != device:
        raise ValueError(f"nms_suppress: iou threshold {iou_thres.dtype} "
                         f"{tuple(iou_thres.shape)} on {iou_thres.device} (one float32 on "
                         f"{device})")
    return iou_thres


@torch.library.custom_op("dyd::nms_suppress", mutates_args=(), device_types="cpu")
def nms_suppress_op(boxes: torch.Tensor, valid: torch.Tensor,
                    iou: torch.Tensor) -> torch.Tensor:
    """``dyd::nms_suppress``: the plain version on the CPU, ``launch`` on the
    card."""
    return nms_suppress_plain(boxes, valid, iou)


@nms_suppress_op.register_kernel("cuda")
def _nms_suppress_cuda(boxes, valid, iou):
    return launch(boxes, valid, iou)


@nms_suppress_op.register_fake
def _nms_suppress_fake(boxes, valid, iou):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def nms_suppress(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thres: Threshold) -> torch.Tensor:
    """boxes (B, K, 4) f32 xyxy, score-descending; valid (B, K) bool; the
    threshold a float or a 0-dim f32 tensor on the boxes' device -> keep
    (B, K) bool."""
    if boxes.device.type == "cpu":
        return nms_suppress_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_suppress: no kernel for device {boxes.device}")
    return nms_suppress_op(boxes, valid, threshold_tensor(iou_thres, boxes.device))


def launch(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: Threshold,
           stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel launch behind ``dyd::nms_suppress`` for CUDA tensors. With
    ``stamps`` ((B, 3) int64 on the card), the walking CTA of each image
    writes its SM clock counts there: staging and its own mask units, the
    whole mask phase (to the cluster barrier), the walk."""
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
    thr = threshold_tensor(iou_thres, boxes.device)
    b, k, _ = boxes.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    geometry = nms_geometry(b, k, active_clusters(boxes.device))
    if stamps is not None and (geometry.in_global or stamps.shape != (b, 3)
                               or stamps.dtype != torch.int64 or stamps.device != boxes.device):
        raise ValueError("nms_suppress: stamps must be (B, 3) int64 on the boxes' device, "
                         f"and K <= {MAX_K}")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        if geometry.in_global:
            bits = torch.empty(bitmask_words(b, k), dtype=torch.int32, device=boxes.device)
            fn = _build.function("nms_suppress", "nms_suppress_global", _GLOBAL_ARGS)
            err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), bits.data_ptr(), b, k,
                     thr.data_ptr(), geometry.blocks, geometry.smem, stream)
        else:
            fn = _build.function("nms_suppress", "nms_suppress", _ARGS)
            err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
                     thr.data_ptr(), geometry.cluster, geometry.first, geometry.smem,
                     None if stamps is None else stamps.data_ptr(), stream)
    _build.check(err, "nms_suppress launch")
    _build.count_launch(__name__)
    return keep

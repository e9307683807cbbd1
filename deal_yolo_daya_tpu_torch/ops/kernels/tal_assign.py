"""The detection loss's task-aligned assigner: the CUDA kernels' wrapper.

Replaces no TPU kernel: the JAX package's assigner is ``jnp`` that XLA fuses
(``csrc/tal_assign.cu`` says why the kernels were added, what bounds them
and how their design meets that bound). Its plain PyTorch version is
``train/loss.py::task_aligned_assign_plain``, dense over (B, N, A); ``launch``
computes the same four outputs per GT over that GT's own candidate anchors,
op for op in the same dtypes.

``train/loss.py::task_aligned_assign`` launches it for CUDA tensors
(``assign_route``) and raises where it cannot; it never falls back.
``launches`` counts the calls (two kernels and a memset each), a CUDA
graph's at each replay (``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

launches = 0

K_MAX = 16           # the largest top-k (csrc/tal_assign.cu)
MAX_GT = 65535       # GT slots an image: the key packs 0xFFFF - n in 16 bits
MAX_IMAGES = 65535   # the first kernel's grid.y
MAX_LEVELS = 8
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
         + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9)


def pow_mode(e: float) -> Tuple[int, float]:
    """How PyTorch's CUDA ``x ** e`` computes a bf16 tensor's power, as the
    kernel repeats it: (mode, exponent) with mode 0 sqrt (e = 0.5), 1 the
    value itself (e = 1), and for the exponent rounded to bf16, 2 ``x * x``,
    3 ``x * x * x`` rounded after each product, 4 ``powf``. Raises for
    e <= 0, which PyTorch computes by other kernels."""
    e = float(e)
    if not e > 0:
        raise ValueError(f"tal_assign: exponent {e} (the kernel takes e > 0)")
    if e == 0.5:
        return 0, e
    if e == 1.0:
        return 1, e
    eb = float(torch.tensor(e, dtype=torch.bfloat16))
    return {2.0: 2, 3.0: 3}.get(eb, 4), eb


def check_args(scores: torch.Tensor, pd_bboxes: torch.Tensor, anchor_xy: torch.Tensor,
               labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor,
               topk: int, grid: Sequence[Tuple[int, int, int]]) -> None:
    """Raise ValueError unless the arguments are what the kernels read:
    scores (B, A, nc) bf16, pd_bboxes (B, A, 4) f32, anchor_xy (A, 2) f32,
    labels (B, N) int64, gt_bboxes (B, N, 4) f32, mask_gt (B, N) bool, all
    contiguous on one device; 1 <= topk <= min(K_MAX, A), N <= MAX_GT,
    B <= MAX_IMAGES; ``grid`` the (stride, rows, cols) of 1 to MAX_LEVELS
    levels whose cells add up to A."""
    if scores.dtype != torch.bfloat16 or scores.dim() != 3:
        raise ValueError(f"tal_assign: scores {scores.dtype} {tuple(scores.shape)} "
                         "((B, A, nc) bfloat16)")
    b, a, _ = scores.shape
    n = gt_bboxes.shape[1] if gt_bboxes.dim() == 3 else -1
    want = {"pd_bboxes": (pd_bboxes, torch.float32, (b, a, 4)),
            "anchor_xy": (anchor_xy, torch.float32, (a, 2)),
            "labels": (labels, torch.int64, (b, n)),
            "gt_bboxes": (gt_bboxes, torch.float32, (b, n, 4)),
            "mask_gt": (mask_gt, torch.bool, (b, n))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"tal_assign: {name} {t.dtype} {tuple(t.shape)} ({dtype} {shape})")
    for name, t in [("scores", scores)] + [(k, v[0]) for k, v in want.items()]:
        if t.device != scores.device:
            raise ValueError(f"tal_assign: {name} on {t.device}, scores on {scores.device}")
        if not t.is_contiguous():
            raise ValueError(f"tal_assign: {name} must be contiguous")
    if not 1 <= topk <= min(K_MAX, a):
        raise ValueError(f"tal_assign: topk {topk} (1 to {min(K_MAX, a)})")
    if n > MAX_GT or b > MAX_IMAGES:
        raise ValueError(f"tal_assign: {b} images of {n} GT slots (at most {MAX_IMAGES} of "
                         f"{MAX_GT})")
    if not 1 <= len(grid) <= MAX_LEVELS or any(min(lv) < 1 for lv in grid) \
            or sum(r * c for _, r, c in grid) != a:
        raise ValueError(f"tal_assign: anchor grid {list(grid)} for {a} anchors (1 to "
                         f"{MAX_LEVELS} levels of (stride, rows, cols))")


def launch(scores: torch.Tensor, pd_bboxes: torch.Tensor, anchor_xy: torch.Tensor,
           labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, nc: int,
           topk: int, alpha: float, beta: float, eps: float,
           grid: Sequence[Tuple[int, int, int]]):
    """The kernels: what ``task_aligned_assign_plain`` computes, for CUDA
    tensors -> (target_bboxes (B, A, 4) f32, target_scores (B, A, nc) f32,
    fg_mask (B, A) bool, target_gt_idx (B, A) int64)."""
    check_args(scores, pd_bboxes, anchor_xy, labels, gt_bboxes, mask_gt, topk, grid)
    if scores.device.type != "cuda":
        raise ValueError(f"tal_assign: no kernel for device {scores.device}")
    if scores.shape[2] != nc:
        raise ValueError(f"tal_assign: scores of {scores.shape[2]} classes, nc {nc}")
    (alpha_mode, alpha_e), (beta_mode, beta_e) = pow_mode(alpha), pow_mode(beta)
    b, a, _ = scores.shape
    n = gt_bboxes.shape[1]
    dev = scores.device
    target_bboxes = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    target_scores = torch.empty((b, a, nc), dtype=torch.float32, device=dev)
    fg_mask = torch.empty((b, a), dtype=torch.bool, device=dev)
    target_gt_idx = torch.empty((b, a), dtype=torch.int64, device=dev)
    if b * a == 0:
        return target_bboxes, target_scores, fg_mask, target_gt_idx
    keys = torch.empty((b, a), dtype=torch.int32, device=dev)
    sel_anchor = torch.empty((b, n, K_MAX), dtype=torch.int32, device=dev)
    sel_value = torch.empty((b, n, K_MAX), dtype=torch.int32, device=dev)
    sel_count = torch.empty((b, n), dtype=torch.int32, device=dev)
    levels = (ctypes.c_int * (3 * len(grid)))(*(int(v) for lv in grid for v in lv))
    with torch.cuda.device(dev):
        fn = _build.function("tal_assign", "tal_assign", _ARGS)
        err = fn(scores.data_ptr(), pd_bboxes.data_ptr(), anchor_xy.data_ptr(),
                 labels.data_ptr(), gt_bboxes.data_ptr(), mask_gt.data_ptr(), b, n, a, nc,
                 topk, alpha_mode, alpha_e, beta_mode, beta_e, eps,
                 ctypes.cast(levels, ctypes.c_void_p), len(grid), keys.data_ptr(),
                 sel_anchor.data_ptr(), sel_value.data_ptr(), sel_count.data_ptr(),
                 target_bboxes.data_ptr(), target_scores.data_ptr(), fg_mask.data_ptr(),
                 target_gt_idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tal_assign launch")
    _build.count_launch(__name__)
    return target_bboxes, target_scores, fg_mask, target_gt_idx

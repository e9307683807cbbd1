"""The on-card augmentation's pixel path: the CUDA kernel's wrapper.

Replaces no TPU kernel: the JAX package's augmentation is ``jnp`` that XLA
fuses (``csrc/device_augment.cu`` says why the kernel was added, what bounds
it and how its design meets that bound). Its plain PyTorch version is
``train/device_augment.py::pixels_plain`` on the separable route (no
rotation or shear): the mosaic's bilinear sampling, the fill, mixup, the HSV
gains, the flips and the u8 store of n samples, from the per-sample numbers
of a ``PixelPlan``. ``launch`` computes the same images in one pass.

``train/device_augment.py::apply`` launches it for CUDA tensors on the
separable route (``route``) and raises where it cannot; it never falls back.
``launches`` counts the kernel launches, a CUDA graph's at each replay
(``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build

launches = 0

MAX_SAMPLES = 65535  # the grid's second dimension (csrc/device_augment.cu)
_ARGS = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


class PixelPlan(NamedTuple):
    """The per-sample numbers of the pixel path for n outputs made from m
    samples (m = n, or 2n where a data-parallel rank makes its rows' mixup
    partners beside them; made sample i < n is output i's own)."""
    idx4: torch.Tensor       # (m, 4) int64: each made sample's four sources (rows of the batch)
    origin_x: torch.Tensor   # (m, 4) f32: each source's origin on the 2S mosaic canvas
    origin_y: torch.Tensor
    i00: torch.Tensor        # (m,) f32: the affine's inverse
    i01: torch.Tensor
    i10: torch.Tensor
    i11: torch.Tensor
    tx: torch.Tensor         # (m,) f32: the affine's translation
    ty: torch.Tensor
    xc: torch.Tensor         # (m,) f32: the mosaic centre on the canvas
    yc: torch.Tensor
    mosaic: torch.Tensor     # (m,) bool: the mosaic gate
    gains: torch.Tensor      # (n, 3) f32: HSV gains
    lr: torch.Tensor         # (n,) bool: flip left-right
    ud: torch.Tensor         # (n,) bool: flip up-down
    bgr: Optional[torch.Tensor]      # (n,) bool: swap the channels; None: never
    partner: Optional[torch.Tensor]  # (n,) int64: the mixup partner's made sample; None: no mixup
    lam: Optional[torch.Tensor]      # (n,) f32: the own image's mixup weight


# the plan's fields the kernel reads: dtype, rows (m made samples or n
# outputs) and trailing shape
_F32, _BOOL = torch.float32, torch.bool
_READ = {"idx4": (torch.int64, "m", (4,)), "origin_x": (_F32, "m", (4,)),
         "origin_y": (_F32, "m", (4,)), "i00": (_F32, "m", ()), "i11": (_F32, "m", ()),
         "tx": (_F32, "m", ()), "ty": (_F32, "m", ()), "xc": (_F32, "m", ()),
         "yc": (_F32, "m", ()), "mosaic": (_BOOL, "m", ()), "partner": (torch.int64, "n", ()),
         "lam": (_F32, "n", ()), "gains": (_F32, "n", (3,)), "lr": (_BOOL, "n", ()),
         "ud": (_BOOL, "n", ()), "bgr": (_BOOL, "n", ())}


def check_args(images: torch.Tensor, hw: torch.Tensor, plan: PixelPlan) -> None:
    """Raise ValueError unless the arguments are what the kernel reads:
    images (B, S, S, 3) u8, hw (B, 2) f32, the plan's fields of the dtypes
    and shapes ``PixelPlan`` gives, ``partner`` and ``lam`` both given or
    both None, all contiguous and on the images' device."""
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[3] != 3 \
            or images.shape[1] != images.shape[2]:
        raise ValueError(f"device_augment: images {images.dtype} {tuple(images.shape)} "
                         "((B, S, S, 3) uint8)")
    if hw.dtype != torch.float32 or tuple(hw.shape) != (images.shape[0], 2):
        raise ValueError(f"device_augment: hw {hw.dtype} {tuple(hw.shape)} ((B, 2) float32)")
    if (plan.partner is None) != (plan.lam is None):
        raise ValueError("device_augment: partner and lam go together")
    rows = {"m": plan.idx4.shape[0], "n": plan.gains.shape[0]}
    if rows["n"] > rows["m"] or rows["n"] > MAX_SAMPLES:
        raise ValueError(f"device_augment: {rows['n']} outputs from {rows['m']} made samples "
                         f"(at most {MAX_SAMPLES}, and no more than made)")
    named = [("images", images), ("hw", hw)]
    for name, (dtype, dim, trailing) in _READ.items():
        t = getattr(plan, name)
        if t is None:
            continue
        shape = (rows[dim],) + trailing
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"device_augment: {name} {t.dtype} {tuple(t.shape)} ({dtype} "
                             f"{shape})")
        named.append((name, t))
    for name, t in named:
        if t.device != images.device:
            raise ValueError(f"device_augment: {name} on {t.device}, images on {images.device}")
        if not t.is_contiguous():
            raise ValueError(f"device_augment: {name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(images: torch.Tensor, hw: torch.Tensor, plan: PixelPlan) -> torch.Tensor:
    """The kernel: what ``pixels_plain`` computes on the separable route, for
    CUDA tensors -> (n, S, S, 3) uint8."""
    check_args(images, hw, plan)
    if images.device.type != "cuda":
        raise ValueError(f"device_augment: no kernel for device {images.device}")
    n, s = plan.gains.shape[0], images.shape[1]
    out = torch.empty((n, s, s, 3), dtype=torch.uint8, device=images.device)
    if n == 0:
        return out
    fields: Sequence[Optional[torch.Tensor]] = (
        images, hw, plan.idx4, plan.origin_x, plan.origin_y, plan.i00, plan.i11, plan.tx,
        plan.ty, plan.xc, plan.yc, plan.mosaic, plan.partner, plan.lam, plan.gains, plan.lr,
        plan.ud, plan.bgr, out)
    with torch.cuda.device(images.device):
        fn = _build.function("device_augment", "device_augment", _ARGS)
        err = fn(*map(_ptr, fields), n, s, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "device_augment launch")
    _build.count_launch(__name__)
    return out

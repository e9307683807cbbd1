"""w8a8 convolution: the CUDA kernel's wrapper and its plain PyTorch version.

The counterpart of ``deal_yolo_daya_tpu/models/quant.py::_int8_conv_call``,
which the JAX package leaves to XLA's int8 ``lax.conv_general_dilated``
(no ``pallas_call``; PyTorch has no int8 convolution on CUDA):

    xq  = clip(round(f32(x) * inv_a), -127, 127)   int8, round half to even
    acc = conv(xq, w_int8)                          s32, stride s, padding k // 2
    y   = (f32(acc) * scale).to(x.dtype)            scale = f32(w_scale * a_scale)

with ``inv_a = f32(1 / a_scale)`` computed once on the host, as JAX computes
``1.0 / a_scale`` in f32. No bias, no activation: the folded BN bias is
added after the cast (``models/quant.py::Int8Conv2d``).

The weights are packed once (``pack_weight``): (Cout, Kp) int8, each row the
(ky, kx, ci) order of an OHWI kernel, zero-padded to Kp, a multiple of 32.
``int8_conv`` takes the plain version for a CPU tensor and launches
``csrc/int8_conv.cu`` for a CUDA tensor (bf16 or f32, NCHW with
channels_last strides; another layout is made channels_last first). The s32
sums are exact in any order, so the kernel equals the plain version bit for
bit, in ``acc`` and in ``y``. ``launches`` counts the kernel launches, a CUDA
graph's at each replay (``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0

K_ALIGN = 32  # the kernel's K step (one mma.m16n8k32 deep)
_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 4 + [ctypes.c_void_p] + \
    [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
    [ctypes.c_void_p]


def pack_weight(w_int8: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) int8 OIHW -> (Cout, Kp) int8: OHWI rows, zero-padded
    to a multiple of 32."""
    cout = w_int8.shape[0]
    rows = w_int8.permute(0, 2, 3, 1).reshape(cout, -1)
    kp = -(-rows.shape[1] // K_ALIGN) * K_ALIGN
    return F.pad(rows, (0, kp - rows.shape[1])).contiguous()


def unpack_weight(packed: torch.Tensor, cin: int, k: int) -> torch.Tensor:
    """``pack_weight``'s inverse: (Cout, Kp) -> (Cout, Cin, k, k) int8."""
    cout = packed.shape[0]
    return packed[:, :k * k * cin].reshape(cout, k, k, cin).permute(0, 3, 1, 2)


def out_size(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def int8_conv_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, inv_a: float,
                    k: int, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch ops -> (y in x's dtype, acc s32),
    both (B, Cout, Ho, Wo). The convolution runs in float64 on integer
    values, exact far past the s32 range (the sums pass 2^24, so not f32)."""
    w = unpack_weight(packed, x.shape[1], k)
    xq = torch.clamp(torch.round(x.float() * inv_a), -127, 127)
    acc = F.conv2d(xq.double(), w.double(), stride=stride, padding=k // 2).to(torch.int32)
    y = (acc.float() * scale.view(1, -1, 1, 1)).to(x.dtype)
    return y, acc


def int8_conv(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, inv_a: float,
              k: int, stride: int) -> torch.Tensor:
    """(B, Cin, H, W) activations -> (B, Cout, Ho, Wo) in x's dtype, by the
    plain version for a CPU tensor and the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, packed, scale, inv_a, k, stride)[0]
    return launch(x, packed, scale, inv_a, k, stride)[0]


def launch(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, inv_a: float, k: int,
           stride: int, with_acc: bool = False):
    """The kernel launch behind ``int8_conv`` for CUDA tensors -> (y, acc or
    None), (B, Cout, Ho, Wo) views of NHWC buffers; ``with_acc`` also writes
    the s32 accumulators."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_conv: x {x.dtype} (bfloat16 / float32)")
    if x.dim() != 4:
        raise ValueError(f"int8_conv: x {tuple(x.shape)}, (B, C, H, W)")
    b, cin, h, w = x.shape
    cout, kp = packed.shape
    if (packed.dtype != torch.int8 or packed.device != x.device or not packed.is_contiguous()
            or kp % K_ALIGN or kp < k * k * cin):
        raise ValueError(f"int8_conv: weights {tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}: contiguous int8 (Cout, Kp) rows of k*k*Cin = "
                         f"{k * k * cin} values padded to a multiple of {K_ALIGN}, on {x.device}")
    if scale.shape != (cout,) or scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError(f"int8_conv: scale {tuple(scale.shape)} {scale.dtype}, ({cout},) f32")
    x = x.contiguous(memory_format=torch.channels_last)  # NHWC in memory
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    acc = torch.empty((b, ho, wo, cout), dtype=torch.int32, device=x.device) \
        if with_acc else None
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    if y.numel() == 0:
        return nchw(y), (nchw(acc) if with_acc else None)
    fn = _build.function("int8_conv", "int8_conv", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), b, h, w, cin, packed.data_ptr(),
                 cout, k, k, stride, kp, inv_a, scale.data_ptr(), y.data_ptr(),
                 acc.data_ptr() if with_acc else None, ho, wo, stream)
    _build.check(err, "int8_conv launch")
    _build.count_launch(__name__)
    return nchw(y), (nchw(acc) if with_acc else None)

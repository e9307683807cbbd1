"""w8a8 ConvBN: the CUDA kernels' wrapper and its plain PyTorch version.

The counterpart of ``deal_yolo_daya_tpu/models/quant.py::_int8_conv_call``,
which the JAX package leaves to XLA's int8 ``lax.conv_general_dilated``
(no ``pallas_call``; PyTorch has no int8 convolution on CUDA), and of the
BN-folded ConvBN's bias and SiLU that follow it:

    xq  = clip(round(f32(x) * inv_a), -127, 127)   int8, round half to even
    acc = conv(xq, w_int8)                          s32, stride s, padding k // 2
    y   = (f32(acc) * scale).to(x.dtype)            scale = f32(w_scale * a_scale)
    z   = y + bias                                  in x.dtype (the folded BN bias)
    out = silu(z) if act else z                     in x.dtype

with ``inv_a = f32(1 / a_scale)`` computed once on the host, as JAX computes
``1.0 / a_scale`` in f32.

The weights are packed once (``pack_weight``): (Cout, Kp) int8, each row the
(ky, kx, ci) order of an OHWI kernel, zero-padded to Kp, a multiple of 32.
``int8_conv_bn`` takes the plain version for a CPU tensor and launches
``csrc/int8_conv.cu`` for a CUDA tensor (bf16 or f32, NCHW with
channels_last strides; a channel slice of such a tensor is read in place,
another layout is made channels_last first). ``plan`` picks the kernel's
route by shape and alignment and lays out its shared memory (the kernel
only checks the plan against the device):

- ``"tma"`` (Cin % 16 == 0, a 16-byte aligned base and pixel stride, the
  ring within shared memory): ``s8_conv_wgmma`` with the halo of each tile
  loaded by TMA into a ring of ``STAGES`` stages, quantized once in the
  block into wgmma's s8 A tile, the weights resident, the epilogue fused;
- ``"direct"`` (the same kernel for the inputs TMA cannot take: a base or
  pixel stride off 16 bytes, or a ring that does not fit beside the
  weights): the halo loaded by the threads themselves;
- ``"narrow"`` (the stem's Cin 3, yolo11n's Cin 8, the widest convs of the
  larger models): ``s8_conv_narrow`` (mma.sync, quantize on load, the same
  epilogue).

For a CUDA tensor ``launch`` runs one of them or raises; it never falls
back to the plain version. The s32 sums are exact in any order, so the
kernels equal the plain version bit for bit in ``acc``; the epilogue rounds
as the plain version rounds. ``launches`` counts the launches of any
route, ``tma_launches``, ``direct_launches`` and ``narrow_launches`` each
route's; a CUDA graph's at each replay (``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0
tma_launches = 0
direct_launches = 0
narrow_launches = 0

K_ALIGN = 32  # the kernels' K step (one wgmma / mma.sync k32 deep)
TILE = 64  # the wgmma kernel's output pixels a tile (8 x 8, or 64 in a row for 1x1)
SMEM_LIMIT = 232448  # shared memory a block may ask for on an H100 (227 KB)
SM_SMEM = 233472  # shared memory of an H100 SM (228 KB)
STAGES = 2  # the TMA ring's stages: the halos in flight while a tile is computed
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WGMMA_ARGS = [_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _F, _P, _P, _I, _P, _P, _I, _I,
               _P, _P]
_NARROW_ARGS = [_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P, _P,
                _I, _I, _P]


@dataclass(frozen=True)
class Plan:
    """A conv's route and, for the wgmma kernel, its tiles and shared-memory
    layout in bytes (``csrc/int8_conv.cu``'s ``PlanField`` order): the N
    tile; the ring's stages (0: no TMA) and channels a TMA box; the halo's
    rows, columns and columns a stride phase; a 16-channel plane of the
    quantized A tile; a box and a stage of the ring; the offset of the
    first of two A tiles and the step to the second; the offsets of the
    weights, the step table, scale|bias, the TMA route's item table and the
    ring's barriers; the bytes a block (128 of them to align the base)."""
    route: str
    nt: int = 0
    stages: int = 0
    cb: int = 0
    hh: int = 0
    wh: int = 0
    whs: int = 0
    plane: int = 0
    box: int = 0
    stage: int = 0
    off_a: int = 0
    a_step: int = 0
    off_b: int = 0
    off_tab: int = 0
    off_sc: int = 0
    off_qt: int = 0
    off_bar: int = 0
    nbytes: int = 0

    def ints(self) -> Tuple[int, ...]:
        return tuple(getattr(self, f.name) for f in fields(self)[1:])


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def _blocks(nbytes: int) -> int:
    """Blocks of ``nbytes`` of shared memory an SM holds (1 KB reserved each)."""
    return SM_SMEM // (nbytes + 1024)


@functools.lru_cache(maxsize=None)
def plan(cin: int, cout: int, k: int, stride: int, esize: int = 2, aligned: bool = True,
         stages: int = STAGES, keep_blocks: bool = True) -> Plan:
    """The route and plan of a conv whose input has ``esize``-byte elements
    (``aligned``: its base and pixel stride are multiples of 16 bytes). The
    wgmma kernel takes Cin % 16 == 0 (16-byte activation rows): by TMA where
    its input is aligned and a ring of at least one stage fits in 227 KB,
    else by its threads' own loads. The N tile is the smallest of 16-256
    that holds Cout, halved down to 64 where the resident weights (Kp times
    the N tile) do not fit. The ring has ``stages`` stages, fewer where
    more would cost the SM a block (``keep_blocks``: it holds as many as
    with one stage, up to half its threads; the kernel waits on latency, so
    the warps an SM holds count for more than a deeper ring). The halo tile
    is (7s + k) rows of 7s + k pixels (64 pixels for 1x1 stride 1),
    quantized into 16-channel planes with the columns split by stride
    phase, into one of two A tiles (the next tile's while the products of
    this one run); the TMA route's item table holds each halo item's place
    in the stage and in the A tile. Else ``"narrow"``."""
    if cin <= 0 or cin % 16 or cout <= 0 or k <= 0 or stride <= 0:
        return Plan("narrow")
    one = k == 1 and stride == 1
    hh, wh = (1, TILE) if one else (7 * stride + k, 7 * stride + k)
    whs = TILE if one else -(-wh // stride)
    plane = (TILE if one else hh * stride * whs) * 16
    kp = _align(k * k * cin, K_ALIGN)
    cb = next(v for v in (256, 128, 64, 32, 16) if cin % v == 0)
    box = _align(hh * wh * cb * esize, 128)
    items = (TILE if one else hh * wh) * (cin // 16)

    def layout(nt, st):
        stage = cin // cb * box if st else 0
        off_a = st * stage
        a_step = _align(cin // 16 * plane, 128)
        off_b = off_a + 2 * a_step
        off_tab = off_b + kp * nt
        off_sc = _align(off_tab + kp // 32 * 8, 16)
        off_qt = off_sc + 8 * nt
        off_bar = _align(off_qt + (4 * items if st else 0), 8)
        return Plan("tma" if st else "direct", nt, st, cb if st else 0, hh, wh, whs, plane,
                    box if st else 0, stage, off_a, a_step, off_b, off_tab, off_sc, off_qt,
                    off_bar, off_bar + 8 * st + 128)

    nt = next((v for v in (16, 32, 64, 128) if cout <= v), 256)
    while True:
        if aligned and stages > 0 and layout(nt, 1).nbytes <= SMEM_LIMIT:
            threads = 128 * (4 if nt >= 64 else nt // 16)  # the kernel's wgs_of
            want = min(2048 // threads // 2, _blocks(layout(nt, 1).nbytes))
            return next(layout(nt, st) for st in range(stages, 0, -1)
                        if layout(nt, st).nbytes <= SMEM_LIMIT
                        and (not keep_blocks or _blocks(layout(nt, st).nbytes) >= want or st == 1))
        if layout(nt, 0).nbytes <= SMEM_LIMIT:
            return layout(nt, 0)
        if nt <= 64:
            return Plan("narrow")
        nt //= 2


def path(cin: int, cout: int, k: int, stride: int, esize: int = 2, aligned: bool = True) -> str:
    """The route that takes a conv (``plan``): ``"tma"`` for 67 of yolo11n's
    74 quantized convs in bf16, ``"direct"`` for 5 whose ring does not fit
    beside their weights and for inputs TMA cannot take, ``"narrow"`` for
    the stem's Cin 3 and yolo11n's Cin 8."""
    return plan(cin, cout, k, stride, esize, aligned).route


def plan_for(x: torch.Tensor, cout: int, k: int, stride: int) -> Plan:
    """The plan ``launch`` takes for the (B, Cin, H, W) input ``x``: aligned
    when its base and pixel stride are multiples of 16 bytes, or when it is
    copied to channels_last first (no NHWC pixel stride)."""
    ldc = pixel_stride(x)
    esize = x.element_size()
    aligned = ldc is None or (x.data_ptr() % 16 == 0 and ldc * esize % 16 == 0)
    return plan(x.shape[1], cout, k, stride, esize, aligned)


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
    """The conv's arithmetic in PyTorch ops -> (y in x's dtype, acc s32),
    both (B, Cout, Ho, Wo). The convolution runs in float64 on integer
    values, exact far past the s32 range (the sums pass 2^24, so not f32)."""
    w = unpack_weight(packed, x.shape[1], k)
    xq = torch.clamp(torch.round(x.float() * inv_a), -127, 127)
    acc = F.conv2d(xq.double(), w.double(), stride=stride, padding=k // 2).to(torch.int32)
    y = (acc.float() * scale.view(1, -1, 1, 1)).to(x.dtype)
    return y, acc


def int8_conv_bn_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, inv_a: float, k: int, stride: int,
                       act: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused function in PyTorch ops -> (out in x's dtype, acc s32), both
    (B, Cout, Ho, Wo): ``int8_conv_plain``, the bias added and the SiLU
    taken in x's dtype, as the unfused ConvBN rounds them."""
    y, acc = int8_conv_plain(x, packed, scale, inv_a, k, stride)
    z = y + bias.view(1, -1, 1, 1)
    return (F.silu(z) if act else z), acc


def int8_conv_bn(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 inv_a: float, k: int, stride: int, act: bool) -> torch.Tensor:
    """(B, Cin, H, W) activations -> (B, Cout, Ho, Wo) in x's dtype, by the
    plain version for a CPU tensor and the kernels for a CUDA tensor."""
    if x.device.type == "cpu":
        return int8_conv_bn_plain(x, packed, scale, bias, inv_a, k, stride, act)[0]
    return launch(x, packed, scale, bias, inv_a, k, stride, act)[0]


def check_args(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               k: int, stride: int) -> None:
    """Raise ValueError for arguments no kernel path takes."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_conv: x {x.dtype} (bfloat16 / float32)")
    if x.dim() != 4:
        raise ValueError(f"int8_conv: x {tuple(x.shape)}, (B, C, H, W)")
    if k < 1 or stride < 1:
        raise ValueError(f"int8_conv: kernel {k}, stride {stride}")
    cin = x.shape[1]
    cout, kp = packed.shape
    if (packed.dtype != torch.int8 or packed.device != x.device or not packed.is_contiguous()
            or kp % K_ALIGN or kp < k * k * cin or kp - k * k * cin >= K_ALIGN):
        raise ValueError(f"int8_conv: weights {tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}: contiguous int8 (Cout, Kp) rows of k*k*Cin = "
                         f"{k * k * cin} values padded to a multiple of {K_ALIGN}, on {x.device}")
    if (scale.shape != (cout,) or scale.dtype != torch.float32 or not scale.is_contiguous()
            or scale.device != x.device):
        raise ValueError(f"int8_conv: scale {tuple(scale.shape)} {scale.dtype}, ({cout},) f32 "
                         f"on {x.device}")
    if (bias.shape != (cout,) or bias.dtype != x.dtype or not bias.is_contiguous()
            or bias.device != x.device):
        raise ValueError(f"int8_conv: bias {tuple(bias.shape)} {bias.dtype}, ({cout},) "
                         f"{x.dtype} on {x.device}")


def pixel_stride(x: torch.Tensor) -> Optional[int]:
    """The elements between neighbouring pixels when the (B, C, H, W) view
    ``x`` is NHWC in memory with its channels contiguous (a channels_last
    tensor, or a channel slice of one), else None."""
    b, c, h, w = x.shape
    if x.is_contiguous(memory_format=torch.channels_last):
        return c
    sb, sc, sh, ldc = x.stride()
    if w == 1 or sc != 1 or ldc < c or (h > 1 and sh != w * ldc) or (b > 1 and sb != h * w * ldc):
        return None
    return ldc


def launch(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           inv_a: float, k: int, stride: int, act: bool, with_acc: bool = False,
           use: Optional[Plan] = None):
    """The kernel launches behind ``int8_conv_bn`` for CUDA tensors ->
    (out, acc or None), (B, Cout, Ho, Wo) views of NHWC buffers; ``with_acc``
    also writes the s32 sums. ``use`` replaces ``plan``'s choice (a
    timing tool compares routes and ring depths with it)."""
    check_args(x, packed, scale, bias, k, stride)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x.device}")
    b, cin, h, w = x.shape
    cout, kp = packed.shape
    pl = use or plan_for(x, cout, k, stride)
    ldc = pixel_stride(x)
    if ldc is None:
        x, ldc = x.contiguous(memory_format=torch.channels_last), cin
    if pl.route == "tma" and (x.data_ptr() % 16 or ldc * x.element_size() % 16):
        raise ValueError("int8_conv: the TMA route needs a 16-byte aligned base and pixel stride")
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    acc = torch.empty((b, ho, wo, cout), dtype=torch.int32, device=x.device) \
        if with_acc else None
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    if y.numel() == 0:
        return nchw(y), (nchw(acc) if with_acc else None)
    is_bf16 = int(x.dtype == torch.bfloat16)
    acc_ptr = acc.data_ptr() if with_acc else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if pl.route == "narrow":
            err = _build.function("int8_conv", "s8_conv_narrow", _NARROW_ARGS)(
                x.data_ptr(), is_bf16, b, h, w, cin, ldc, packed.data_ptr(), cout, k, k, stride,
                kp, inv_a, scale.data_ptr(), bias.data_ptr(), int(act), y.data_ptr(), acc_ptr,
                ho, wo, stream)
            _build.check(err, "s8_conv_narrow launch")
        else:
            err = _build.function("int8_conv", "s8_conv_wgmma", _WGMMA_ARGS)(
                x.data_ptr(), is_bf16, b, h, w, cin, ldc, packed.data_ptr(), cout, k, stride, kp,
                inv_a, scale.data_ptr(), bias.data_ptr(), int(act), y.data_ptr(), acc_ptr, ho, wo,
                _plan_ints(pl), stream)
            _build.check(err, f"s8_conv_wgmma launch ({pl.route})")
        _build.count_launch(__name__, f"{pl.route}_launches")
    _build.count_launch(__name__)
    return nchw(y), (nchw(acc) if with_acc else None)


@functools.lru_cache(maxsize=None)
def _plan_ints(pl: Plan) -> ctypes.Array:
    return (ctypes.c_int * len(pl.ints()))(*pl.ints())

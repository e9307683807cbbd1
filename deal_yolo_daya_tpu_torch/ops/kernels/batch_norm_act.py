"""Train-mode BatchNorm with its optional SiLU: one autograd Function over
the CUDA kernels (``csrc/batch_norm_act.cu``) and their plain PyTorch
version.

Replaces no TPU kernel: the JAX package's BatchNorm is flax's, which XLA
fuses (the source's header says why the kernels were added and what bounds
them). The semantics are flax's ``BatchNorm(momentum, epsilon)`` in
training: normalise with the batch mean and the biased batch variance,
statistics in f32 whatever the input dtype, and move the running mean and
variance toward those same two (``running = momentum * running + (1 -
momentum) * batch``) unless ``update_stats`` is False (a checkpointed
block's recomputation). With ``act`` the output is ``silu`` of the
normalised value, rounded once to the input's dtype.

``BatchNormAct`` takes a CUDA input through the kernels, two launches
forward (statistics with the running update, then the output) and two
backward (the per-channel sums with the weight and bias gradients, then the
input gradient), or raises; it never falls back. A CPU input takes the
plain version, ``forward_plain`` and ``backward_plain``, which is also the
card's reference. The forward keeps only x and the per-channel statistics
for the backward, which computes SiLU's input again.

The kernels read a 4-d input laid out as channels_last rows (N*H*W rows of
C contiguous channels, rows possibly strided, as a channel slice of a
larger tensor); another layout is copied to channels_last first, counted in
``layout_copies``. ``launches`` counts the kernel launches (a CUDA graph's
at each replay, ``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0
layout_copies = 0

THREADS = 256      # a block's threads
SMS = 132          # an H100's SMs
BLOCKS = 2 * SMS   # the blocks a pass aims at (the best of 64 to 1056 on an H100)
MIN_ROWS = 8       # rows a thread takes at least, where the input has them
TILE_BYTES = 128   # the channels a block's row covers with 16-byte loads
MAX_TILES = 4096   # csrc/batch_norm_act.cu's ticket counters
MERGE = 64         # csrc/batch_norm_act.cu: partials one merge takes at most
MAX_ROW_BLOCKS = MERGE * MERGE
DTYPES = (torch.bfloat16, torch.float32)

_FWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """A launch's geometry: ``vec`` channels a thread loads at once, ``tcx``
    threads across a block's channel tile, ``ry`` rows a block takes at
    once, ``tiles`` channel tiles, ``gy`` row blocks of ``rows`` rows, their
    partials merged in groups of ``group`` row blocks."""
    vec: int
    tcx: int
    ry: int
    tiles: int
    gy: int
    rows: int
    group: int


def plan(m: int, c: int, esize: int, vector: bool) -> Plan:
    """The geometry for an (m, c) input of ``esize``-byte elements: 16-byte
    loads where ``vector`` (the wrapper's test that c, the row strides and
    the addresses allow them), else one element a load; a block's tile of
    a power of two of lanes up to TILE_BYTES of channels (32 lanes without
    vectors), the rest of its THREADS on rows; row blocks enough for about
    BLOCKS blocks in all, with at least MIN_ROWS rows a thread where m has
    them; the partials merged in one level up to MERGE row blocks, else in
    as few groups of at most MERGE as hold them."""
    vec = 16 // esize if vector else 1
    lanes = -(-c // vec)
    tcx = min(1 << (lanes - 1).bit_length(), TILE_BYTES // 16 if vector else 32)
    ry = THREADS // tcx
    tiles = -(-lanes // tcx)
    gy = max(1, min(-(-m // (ry * MIN_ROWS)), -(-BLOCKS // tiles), MAX_ROW_BLOCKS))
    rows = -(-m // gy)
    gy = -(-m // rows)
    group = -(-gy // -(-gy // MERGE))
    return Plan(vec, tcx, ry, tiles, gy, rows, group)


def scratch_floats(p: Plan, c: int) -> int:
    """The partials' scratch of a launch: two planes of (row blocks, C)
    and two of (groups, C)."""
    return 2 * (p.gy + -(-p.gy // p.group)) * c


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride in elements between the rows of the 4-d ``t`` seen as
    (N*H*W, C) rows of contiguous channels (channels_last, or a channel
    slice of such a tensor); None where it is not so laid out."""
    if t.dim() != 4:
        return None
    n, c, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    if c > 1 and sc != 1:
        return None
    dims = [(size, st) for size, st in ((n, sn), (h, sh), (w, sw)) if size > 1]
    if not dims:
        return c
    ld = expect = dims[-1][1]
    for size, st in reversed(dims):
        if st != expect:
            return None
        expect *= size
    return ld if ld >= c else None


def _rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``t`` and its row stride, copied to channels_last first (counted)
    where it has none."""
    ld = row_stride(t)
    if ld is None:
        t = t.contiguous(memory_format=torch.channels_last)
        _build.count_launch(__name__, "layout_copies")
        ld = t.shape[1]
    return t, ld


def _vectors(esize: int, c: int, *pairs) -> bool:
    """Whether 16-byte loads fit: c, each row stride and each address a
    multiple of 16 bytes' elements."""
    vec = 16 // esize
    return c % vec == 0 and all(ld % vec == 0 and t.data_ptr() % 16 == 0 for t, ld in pairs)


def _check(x: torch.Tensor, *params: torch.Tensor) -> None:
    """Raise ValueError unless x is a 4-d bf16 or f32 CUDA tensor of at
    least one row and each parameter a contiguous f32 (C,) on its device."""
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_act: no kernel for device {x.device}")
    if x.dtype not in DTYPES or x.dim() != 4:
        raise ValueError(f"batch_norm_act: x {x.dtype} {tuple(x.shape)} (4-d bfloat16 or float32)")
    c = x.shape[1]
    if c < 1 or x.numel() == 0:
        raise ValueError(f"batch_norm_act: x {tuple(x.shape)} holds no value")
    for t in params:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"batch_norm_act: a parameter {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} (contiguous float32 ({c},) on {x.device})")


def forward_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, act: bool,
                   update_stats: bool, eps: float, momentum: float):
    """The forward kernels -> (z, mean, invstd, x as the kernels read it)."""
    _check(x, weight, bias, running_mean, running_var)
    x, ld = _rows(x)
    c = x.shape[1]
    m = x.numel() // c
    p = plan(m, c, x.element_size(), _vectors(x.element_size(), c, (x, ld)))
    if p.tiles > MAX_TILES:
        raise ValueError(f"batch_norm_act: {c} channels (at most {MAX_TILES * p.tcx * p.vec})")
    dev = x.device
    z = torch.empty(x.shape, dtype=x.dtype, device=dev, memory_format=torch.channels_last)
    mean = torch.empty((c,), dtype=torch.float32, device=dev)
    invstd = torch.empty((c,), dtype=torch.float32, device=dev)
    part = torch.empty((scratch_floats(p, c),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = _build.function("batch_norm_act", "dyd_bn_forward", _FWD_ARGS)
        err = fn(x.data_ptr(), z.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                 running_mean.data_ptr(), running_var.data_ptr(), part.data_ptr(),
                 weight.data_ptr(), bias.data_ptr(), int(x.dtype == torch.bfloat16), p.vec,
                 int(act), int(update_stats), m, c, ld, p.tcx, p.ry, p.rows, p.tiles, p.gy,
                 p.group, eps, momentum, 1.0 - momentum, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "batch_norm_act forward launch")
    _build.count_launch(__name__)
    _build.count_launch(__name__)
    return z, mean, invstd, x


def backward_kernel(dz: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor, act: bool):
    """The backward kernels -> (dx, d_weight, d_bias); x as the forward
    kernels read it."""
    _check(x, weight, bias, mean, invstd)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device:
        raise ValueError(f"batch_norm_act: dz {dz.dtype} {tuple(dz.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    ld_x = row_stride(x)
    if ld_x is None:
        raise ValueError("batch_norm_act: x is not laid out as channels_last rows")
    dz, ld_dz = _rows(dz)
    c = x.shape[1]
    m = x.numel() // c
    p = plan(m, c, x.element_size(),
             _vectors(x.element_size(), c, (x, ld_x), (dz, ld_dz)))
    dev = x.device
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev, memory_format=torch.channels_last)
    d_weight = torch.empty((c,), dtype=torch.float32, device=dev)
    d_bias = torch.empty((c,), dtype=torch.float32, device=dev)
    part = torch.empty((scratch_floats(p, c),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = _build.function("batch_norm_act", "dyd_bn_backward", _BWD_ARGS)
        err = fn(dz.data_ptr(), x.data_ptr(), dx.data_ptr(), mean.data_ptr(),
                 invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
                 d_weight.data_ptr(), d_bias.data_ptr(), int(x.dtype == torch.bfloat16), p.vec,
                 int(act), m, c, ld_dz, ld_x, p.tcx, p.ry, p.rows, p.tiles, p.gy, p.group,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "batch_norm_act backward launch")
    _build.count_launch(__name__)
    _build.count_launch(__name__)
    return dx, d_weight, d_bias


def _channel(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]


def forward_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor, act: bool,
                  update_stats: bool, eps: float, momentum: float):
    """What the forward kernels compute, in plain PyTorch ops, in f32 (or the
    input's wider dtype) -> (z, mean, invstd)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
    invstd = 1.0 / torch.sqrt(var + eps)
    y = (xf - _channel(mean)) * _channel(invstd * weight) + _channel(bias)
    z = F.silu(y) if act else y
    if update_stats:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean.to(running_mean.dtype), alpha=1 - momentum)
            running_var.mul_(momentum).add_(var.to(running_var.dtype), alpha=1 - momentum)
    return z.to(x.dtype), mean, invstd


def backward_plain(dz: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, invstd: torch.Tensor, act: bool):
    """What the backward kernels compute, in plain PyTorch ops, in the
    statistics' dtype -> (dx, d_weight, d_bias)."""
    x_hat = (x.to(mean.dtype) - _channel(mean)) * _channel(invstd)
    g = dz.to(mean.dtype)
    if act:
        y = x_hat * _channel(weight) + _channel(bias)
        s = torch.sigmoid(y)
        g = g * (s * (1 + y * (1 - s)))
    sum_g, sum_gx = g.sum((0, 2, 3)), (g * x_hat).sum((0, 2, 3))
    m = x.numel() // x.shape[1]
    dx = _channel(weight * invstd) * (g - _channel(sum_g / m) - x_hat * _channel(sum_gx / m))
    return dx.to(x.dtype), sum_gx.to(weight.dtype), sum_g.to(bias.dtype)


class BatchNormAct(torch.autograd.Function):
    """Train-mode BatchNorm (+ SiLU with ``act``) of x: the kernels for a
    CUDA input, the plain version for a CPU one. Moves the running
    statistics in place when ``update_stats``."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, act, update_stats, eps,
                momentum):
        if x.is_cuda:
            z, mean, invstd, x = forward_kernel(x, weight, bias, running_mean, running_var, act,
                                                update_stats, eps, momentum)
        else:
            z, mean, invstd = forward_plain(x, weight, bias, running_mean, running_var, act,
                                            update_stats, eps, momentum)
        ctx.act = act
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        return z

    @staticmethod
    def backward(ctx, dz):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        route = backward_kernel if x.is_cuda else backward_plain
        dx, d_weight, d_bias = route(dz, x, weight, bias, mean, invstd, ctx.act)
        return dx, d_weight, d_bias, None, None, None, None, None, None


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, act: bool,
                   update_stats: bool, eps: float, momentum: float) -> torch.Tensor:
    """``BatchNormAct.apply``: train-mode BatchNorm of x with flax's
    ``momentum`` and ``eps``, then SiLU where ``act``."""
    return BatchNormAct.apply(x, weight, bias, running_mean, running_var, bool(act),
                              bool(update_stats), float(eps), float(momentum))

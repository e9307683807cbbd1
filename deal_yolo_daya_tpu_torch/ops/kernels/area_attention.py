"""Area attention: the CUDA kernels' wrappers, their plain PyTorch versions,
and the autograd Function that pairs forward and backward.

Replaces the TPU kernels of ``deal_yolo_daya_tpu/ops/pallas/area_attention.py``:
``_kernel`` (the forward, ``csrc/area_attention.cu``) and ``_bwd_kernel``
(the backward, ``csrc/area_attention_bwd.cu``), which the JAX package pairs
under a ``custom_vjp``.

For each (batch x area) chunk and head the forward computes
``softmax(q k^T * key_dim**-0.5) v`` with f32 scores, and returns the
contiguous per-head-concat ``v`` beside it for the positional-encoding conv.
The backward takes the cotangents of both outputs and returns the gradient
with respect to ``qkv``, recomputing P as the TPU kernel does: only ``qkv`` is
saved for it.

What bounds them on an H100: the bytes. At yolo11n's C2PSA shape (32 chunks
of 400 tokens, 2 heads, key_dim 32, head_dim 64, bf16) the forward moves
13 MB for ~2 GFLOP and the backward 19.7 MB for ~4.6 GFLOP; yolo12n's AAttn
calls (key_dim = head_dim = 32) at 640 px are (128, 400, 192) with 2 heads
and (32, 400, 384) with 4, 32.8 and 16.4 MB a forward. The TPU kernels
held a chunk's whole (n, n) f32 score tile in VMEM; on Hopper that tile
(640 KB) does not fit in a block's 227 KB of shared memory, so both CUDA
kernels stream key (or query) tiles into shared memory by TMA and recompute
scores: the (n, n) scores never reach device memory, and the ragged edge
(n = 400 is not a multiple of the tile) is zero-filled and masked. In bf16
the products are Hopper's wgmma with the scores, P and the sums in
registers; in f32 the kernels stay on the f32 CUDA cores. The wrappers set
the C functions' argument types once (``_build.function``) and build the
TMA descriptors in C on every call: they hold the tensors' addresses.

The forward kernel is the custom op ``dyd::area_attention_fwd(qkv,
num_heads, head_dim, key_dim) -> (out, v)`` (``torch.library``): its CUDA
implementation is ``area_attention_fwd``, its CPU implementation the plain
version, and its fake implementation gives ``torch.export`` the outputs'
shapes, so an exported program holds the op. The backward stays a direct
launch: no exported program differentiates.

``area_attention`` goes through ``AreaAttention`` on every device: the plain
versions for a CPU tensor (a trace on the CPU holds only aten ops), the op
and the backward kernel for a CUDA tensor. ``launches`` and
``bwd_launches`` count the kernel launches, a CUDA graph's at each replay
(``_build.count_launch``); ``k36_launches`` and ``k36_bwd_launches`` count
those of the (36, 72) build alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0
bwd_launches = 0
k36_launches = 0
k36_bwd_launches = 0
K36 = (36, 72)  # (key_dim, head_dim) of yolov10m's PSA heads

# (key_dim, head_dim) pairs the kernels are built for: yolo11's C2PSA heads
# (32, 64), yolo12's AAttn heads (32, 32) and yolov10m's PSA heads (36, 72),
# whose k columns start 8-byte aligned only (the kernels copy that pair's
# operands with cp.async instead of TMA: csrc/hopper.cuh, namespace k36)
SUPPORTED = {(32, 64), (32, 32), K36}

# the C entry points' arguments: pointers, ints (dims), scale, is_bf16, stream
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]


def _split(qkv: torch.Tensor, num_heads: int, head_dim: int, key_dim: int):
    ba, n, _ = qkv.shape
    x = qkv.view(ba, n, num_heads, 2 * key_dim + head_dim)
    return x[..., :key_dim], x[..., key_dim:2 * key_dim], x[..., 2 * key_dim:]


def area_attention_plain(qkv: torch.Tensor, num_heads: int, head_dim: int,
                         key_dim: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's arithmetic in PyTorch ops: f32 scores, P normalized
    and cast to the input dtype, P.V accumulated in f32."""
    key_dim = head_dim if key_dim is None else key_dim
    ba, n, _ = qkv.shape
    q, k, v = _split(qkv, num_heads, head_dim, key_dim)
    scale = torch.tensor(key_dim ** -0.5, dtype=torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    dim = num_heads * head_dim
    return out.reshape(ba, n, dim).to(qkv.dtype), v.reshape(ba, n, dim)


def area_attention_bwd_plain(qkv: torch.Tensor, d_out: torch.Tensor, d_v: torch.Tensor,
                             num_heads: int, head_dim: int,
                             key_dim: Optional[int] = None) -> torch.Tensor:
    """The TPU backward kernel's arithmetic in PyTorch ops: P recomputed in
    f32; dV = P(in the input dtype)^T dO + dvo; dP = dO V^T;
    dS = P * (dP - rowsum(dP * P)) * scale, cast to the input dtype;
    dQ = dS K and dK = dS^T Q accumulated in f32; written as interleaved
    q|k|v columns like ``qkv``."""
    key_dim = head_dim if key_dim is None else key_dim
    ba, n, total = qkv.shape
    dt, f32 = qkv.dtype, torch.float32
    q, k, v = (t.float() for t in _split(qkv, num_heads, head_dim, key_dim))
    do = d_out.reshape(ba, n, num_heads, head_dim).float()
    dvo = d_v.reshape(ba, n, num_heads, head_dim).float()
    scale = torch.tensor(key_dim ** -0.5, dtype=f32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).to(f32), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * scale).to(dt).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([dq, dk, dv + dvo], dim=-1).to(dt).reshape(ba, n, total)


def _check(qkv: torch.Tensor, num_heads: int, head_dim: int, key_dim: int,
           what: str) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {qkv.dtype} (float32 or bfloat16)")
    if (key_dim, head_dim) not in SUPPORTED:
        raise ValueError(f"{what}: (key_dim, head_dim)={(key_dim, head_dim)} "
                         f"not in {sorted(SUPPORTED)}")
    if qkv.dim() != 3 or qkv.shape[2] != num_heads * (2 * key_dim + head_dim):
        raise ValueError(f"{what}: qkv shape {tuple(qkv.shape)} does not "
                         f"match {num_heads} heads of {key_dim}|{key_dim}|{head_dim}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be contiguous and 16-byte aligned")


def area_attention_fwd(qkv: torch.Tensor, num_heads: int, head_dim: int, key_dim: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on a CUDA ``qkv`` -> (out, v)."""
    _check(qkv, num_heads, head_dim, key_dim, "area_attention")
    ba, n, _ = qkv.shape
    out = torch.empty((ba, n, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(out)
    if ba == 0 or n == 0:
        return out, v
    fn = _build.function("area_attention", "area_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), v.data_ptr(), ba, n, num_heads,
                 key_dim, head_dim, key_dim ** -0.5, int(qkv.dtype == torch.bfloat16),
                 stream)
    _build.check(err, "area_attention launch")
    _build.count_launch(__name__)
    if (key_dim, head_dim) == K36:
        _build.count_launch(__name__, "k36_launches")
    return out, v


def area_attention_bwd(qkv: torch.Tensor, d_out: torch.Tensor, d_v: torch.Tensor,
                       num_heads: int, head_dim: int, key_dim: int) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors -> d_qkv like ``qkv``.
    ``d_out`` and ``d_v`` are (BA, n, heads*head_dim), contiguous, in
    ``qkv``'s dtype."""
    _check(qkv, num_heads, head_dim, key_dim, "area_attention_bwd")
    ba, n, _ = qkv.shape
    for name, t in (("d_out", d_out), ("d_v", d_v)):
        if (t.shape != (ba, n, num_heads * head_dim) or t.dtype != qkv.dtype
                or t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"area_attention_bwd: {name} {tuple(t.shape)} {t.dtype} "
                             f"must be a contiguous, 16-byte aligned "
                             f"{(ba, n, num_heads * head_dim)} {qkv.dtype} tensor "
                             f"on {qkv.device}")
    d_qkv = torch.empty_like(qkv)
    if ba == 0 or n == 0:
        return d_qkv
    # per query row: softmax max, denominator and rowsum(dP * P), f32
    stats = torch.empty((3, ba, num_heads, n), dtype=torch.float32, device=qkv.device)
    fn = _build.function("area_attention_bwd", "area_attention_bwd", _BWD_ARGS)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), d_out.data_ptr(), d_v.data_ptr(), d_qkv.data_ptr(),
                 stats.data_ptr(), ba, n, num_heads, key_dim, head_dim, key_dim ** -0.5,
                 int(qkv.dtype == torch.bfloat16), stream)
    _build.check(err, "area_attention_bwd launch")
    _build.count_launch(__name__, "bwd_launches")
    if (key_dim, head_dim) == K36:
        _build.count_launch(__name__, "k36_bwd_launches")
    return d_qkv


@torch.library.custom_op("dyd::area_attention_fwd", mutates_args=(), device_types="cpu")
def area_attention_op(qkv: torch.Tensor, num_heads: int, head_dim: int,
                      key_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dyd::area_attention_fwd``: the plain version on the CPU,
    ``area_attention_fwd`` on the card."""
    with torch.autocast("cpu", enabled=False):  # the dtypes are the kernel's
        return area_attention_plain(qkv, num_heads, head_dim, key_dim)


@area_attention_op.register_kernel("cuda")
def _area_attention_cuda(qkv, num_heads, head_dim, key_dim):
    # the kernel's TMA maps need a contiguous, 16-byte aligned qkv, and a
    # traced program may hand the op a view: such an input is copied first
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        qkv = qkv.clone(memory_format=torch.contiguous_format)
    return area_attention_fwd(qkv, num_heads, head_dim, key_dim)


@area_attention_op.register_fake
def _area_attention_fake(qkv, num_heads, head_dim, key_dim):
    shape = (qkv.shape[0], qkv.shape[1], num_heads * head_dim)
    return qkv.new_empty(shape), qkv.new_empty(shape)


class AreaAttention(torch.autograd.Function):
    """Differentiable area attention: the kernels on a CUDA tensor, the plain
    versions on a CPU tensor. Saves only ``qkv``, as the TPU VJP does."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim, key_dim):
        ctx.save_for_backward(qkv)
        ctx.dims = (num_heads, head_dim, key_dim)
        ctx.set_materialize_grads(False)
        if qkv.device.type == "cuda":
            return area_attention_op(qkv, num_heads, head_dim, key_dim)
        if not torch.is_autocast_enabled("cpu"):  # no autocast region in a traced program
            return area_attention_plain(qkv, num_heads, head_dim, key_dim)
        with torch.autocast("cpu", enabled=False):  # the dtypes are the kernel's
            return area_attention_plain(qkv, num_heads, head_dim, key_dim)

    @staticmethod
    def backward(ctx, d_out, d_v):
        (qkv,) = ctx.saved_tensors
        num_heads, head_dim, key_dim = ctx.dims
        shape = (qkv.shape[0], qkv.shape[1], num_heads * head_dim)
        # the cotangents come through PSAAttention's permute: make them
        # contiguous; an output that reached no loss has none
        d_out, d_v = (torch.zeros(shape, dtype=qkv.dtype, device=qkv.device) if d is None
                      else d.to(qkv.dtype).contiguous() for d in (d_out, d_v))
        if qkv.device.type == "cpu":
            d_qkv = area_attention_bwd_plain(qkv, d_out, d_v, num_heads, head_dim, key_dim)
        else:
            d_qkv = area_attention_bwd(qkv, d_out, d_v, num_heads, head_dim, key_dim)
        return d_qkv, None, None, None


def area_attention(qkv: torch.Tensor, num_heads: int, head_dim: int,
                   key_dim: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qkv (BA, n, heads*(2*key_dim+head_dim)), per-head interleaved q|k|v
    -> (out, v), each (BA, n, heads*head_dim). key_dim defaults to head_dim.
    Differentiable with respect to ``qkv``."""
    key_dim = head_dim if key_dim is None else key_dim
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"area_attention: no kernel for device {qkv.device}")
    return AreaAttention.apply(qkv, num_heads, head_dim, key_dim)

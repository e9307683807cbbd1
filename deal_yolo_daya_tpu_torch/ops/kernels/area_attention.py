"""Area attention: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``deal_yolo_daya_tpu/ops/pallas/area_attention.py::_kernel``
(the forward; the backward is training and comes with the training step).

For each (batch x area) chunk and head it computes
``softmax(q k^T * key_dim**-0.5) v`` with f32 scores, and returns the
contiguous per-head-concat ``v`` beside it for the positional-encoding conv.

What bounds it on an H100: the bytes. At yolo11n's C2PSA shape (32 chunks of
400 tokens, 2 heads, key_dim 32, head_dim 64, bf16) the function reads 6.6 MB
and writes 6.6 MB but does only ~2 GFLOP. The TPU kernel held a chunk's whole
(n, n) f32 score tile in VMEM; on Hopper that tile (640 KB) does not fit in a
block's 227 KB of shared memory, so ``csrc/area_attention.cu`` streams key and
value tiles with an online softmax: the (n, n) scores never reach device
memory, and the ragged edge (n = 400 is not a multiple of the tile) is masked
in the kernel. In bf16, Q.K^T and P.V run on the tensor cores (WMMA); in f32
the kernel stays on the f32 CUDA cores, exact to the plain version's
precision.

``area_attention`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0

SUPPORTED = {(32, 64)}  # (key_dim, head_dim) pairs the kernel is built for


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


def area_attention(qkv: torch.Tensor, num_heads: int, head_dim: int,
                   key_dim: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qkv (BA, n, heads*(2*key_dim+head_dim)), per-head interleaved q|k|v
    -> (out, v), each (BA, n, heads*head_dim). key_dim defaults to head_dim."""
    key_dim = head_dim if key_dim is None else key_dim
    if qkv.device.type == "cpu":
        return area_attention_plain(qkv, num_heads, head_dim, key_dim)
    if qkv.device.type != "cuda":
        raise ValueError(f"area_attention: no kernel for device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"area_attention: dtype {qkv.dtype} (float32 or bfloat16)")
    if (key_dim, head_dim) not in SUPPORTED:
        raise ValueError(f"area_attention: (key_dim, head_dim)={(key_dim, head_dim)} "
                         f"not in {sorted(SUPPORTED)}")
    if qkv.dim() != 3 or qkv.shape[2] != num_heads * (2 * key_dim + head_dim):
        raise ValueError(f"area_attention: qkv shape {tuple(qkv.shape)} does not "
                         f"match {num_heads} heads of {key_dim}|{key_dim}|{head_dim}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("area_attention: qkv must be contiguous and 16-byte aligned")
    ba, n, _ = qkv.shape
    out = torch.empty((ba, n, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(out)
    if ba == 0 or n == 0:
        return out, v
    lib = _build.load("area_attention")
    fn = lib.area_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), v.data_ptr(), ba, n, num_heads,
                 key_dim, head_dim, key_dim ** -0.5, int(qkv.dtype == torch.bfloat16),
                 stream)
    _build.check(err, "area_attention launch")
    global launches
    launches += 1
    return out, v

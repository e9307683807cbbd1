"""YOLO11 building blocks as PyTorch modules, NCHW.

Counterpart of ``deal_yolo_daya_tpu/models/blocks.py`` for the blocks yolo11
uses. Submodules carry the ultralytics ``DetectionModel`` names (``conv``,
``bn``, ``cv1``, ``m.0``, ``attn.qkv``, ``ffn.0`` ...), so a state dict in
ultralytics layout loads with ``load_state_dict(strict=True)``.

Convolutions pad symmetrically by k//2 and BatchNorm uses eps 1e-3, as in the
JAX package. ``PSAAttention`` runs the area-attention kernel
(``ops/kernels/area_attention.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.area_attention import area_attention

BN_EPS = 1e-3


class BatchNorm(nn.Module):
    """Inference BatchNorm with eps 1e-3 and the ultralytics state-dict names
    (weight, bias, running_mean, running_var; no ``num_batches_tracked``,
    which the JAX export does not carry)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=BN_EPS)


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + optional SiLU. After ``fuse_conv_bn``
    the BN is folded into the conv's weight and bias and ``bn`` is Identity."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


def DWConv(c1: int, c2: int, k: int = 3, s: int = 1, act: bool = True) -> ConvBN:
    """Depthwise ConvBN (the ultralytics DWConv is itself the Conv)."""
    return ConvBN(c1, c2, k, s, g=c1, act=act)


class Bottleneck(nn.Module):
    """Two convs with a residual when the widths match."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        hidden = int(c2 * e)
        self.cv1 = ConvBN(c1, hidden, k[0])
        self.cv2 = ConvBN(hidden, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP block with 3 convs and n bottlenecks of kernel k."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, k: int = 3):
        super().__init__()
        hidden = int(c2 * e)
        self.cv1 = ConvBN(c1, hidden)
        self.cv2 = ConvBN(c1, hidden)
        self.cv3 = ConvBN(2 * hidden, c2)
        self.m = nn.Sequential(*(Bottleneck(hidden, hidden, shortcut, (k, k), 1.0)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    """Fast CSP block: split, run n inner modules on the running tail, concat
    every chunk (C3k inners when c3k, else Bottlenecks of expansion 0.5)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.hidden = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.hidden)
        self.cv2 = ConvBN((2 + n) * self.hidden, c2)
        self.m = nn.ModuleList(
            C3k(self.hidden, self.hidden, 2, shortcut) if c3k
            else Bottleneck(self.hidden, self.hidden, shortcut, (3, 3), 0.5)
            for _ in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = list(self.cv1(x).split(self.hidden, 1))
        for m in self.m:
            chunks.append(m(chunks[-1]))
        return self.cv2(torch.cat(chunks, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained k x k max-pools, padded
    with -inf."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        hidden = c1 // 2
        self.cv1 = ConvBN(c1, hidden)
        self.cv2 = ConvBN(4 * hidden, c2)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(pools, 1))


class PSAAttention(nn.Module):
    """Position-sensitive multi-head attention over the H x W grid: 1x1 qkv
    conv, area attention (one area), a depthwise 3x3 positional encoding on
    V, and a 1x1 projection. q/k are ``key_dim = head_dim * attn_ratio`` wide
    and the scale is ``key_dim ** -0.5``."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        total = num_heads * (2 * self.key_dim + self.head_dim)
        self.qkv = ConvBN(dim, total, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        qkv = self.qkv(x)
        # (B, C, H, W) -> (B, H*W, C): free when the activation is channels_last
        tokens = qkv.permute(0, 2, 3, 1).reshape(b, h * w, -1).contiguous()
        out, v = area_attention(tokens, self.num_heads, self.head_dim, self.key_dim)
        out = out.view(b, h, w, -1).permute(0, 3, 1, 2)
        v = v.view(b, h, w, -1).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class PSABlock(nn.Module):
    """Attention + 2-layer conv FFN, both residual."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.attn = PSAAttention(dim, num_heads, attn_ratio)
        self.ffn = nn.Sequential(ConvBN(dim, 2 * dim), ConvBN(2 * dim, dim, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """CSP wrapper around n PSA blocks (heads = max(hidden // 64, 1))."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.hidden = int(c2 * e)
        heads = max(self.hidden // 64, 1)
        self.cv1 = ConvBN(c1, 2 * self.hidden)
        self.cv2 = ConvBN(2 * self.hidden, c2)
        self.m = nn.Sequential(*(PSABlock(self.hidden, heads) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split(self.hidden, 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")

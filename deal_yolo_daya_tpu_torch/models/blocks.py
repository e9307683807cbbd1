"""YOLO11, YOLOv8 and YOLOv12 building blocks as PyTorch modules, NCHW.

Counterpart of ``deal_yolo_daya_tpu/models/blocks.py`` for the blocks the
three families use. Submodules carry the ultralytics ``DetectionModel`` names (``conv``,
``bn``, ``cv1``, ``m.0``, ``attn.qkv``, ``ffn.0`` ...), so a state dict in
ultralytics layout loads with ``load_state_dict(strict=True)``.

Convolutions pad symmetrically by k//2 and BatchNorm uses eps 1e-3 and flax's
momentum, as in the JAX package; ``model.train()`` and ``model.eval()`` switch
BatchNorm between batch and running statistics. ``PSAAttention`` (yolo11's
C2PSA) and ``AAttn`` (yolo12's A2C2f) run the area-attention kernels
(``ops/kernels/area_attention.py``), forward and backward.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.area_attention import area_attention

BN_EPS = 1e-3
BN_MOMENTUM = 0.97  # flax's: running = 0.97 * running + 0.03 * batch


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a data-parallel group
    (``dp``), so that the output and the input gradient are the
    one-process module's on the whole batch. Every rank holds as many rows.
    Returns (y, mean, biased variance); the weight and bias gradients are
    this rank's sums (the gradient all-reduce adds them).

    On the card it runs PyTorch's own batch-norm kernels, the ones
    ``torch.nn.SyncBatchNorm`` uses: each rank's (mean, 1/std) gathered and
    combined by count, the normalisation, and in the backward the sums of
    dy and dy * (x - mean) all-reduced. On the CPU, where those kernels do
    not exist, the same arithmetic in plain ops, in f32 or the input's wider
    dtype: (mean, variance) pairs gathered and combined, and the sums of dy
    and dy * x_hat all-reduced."""

    @staticmethod
    def forward(ctx, x, weight, bias, dp):
        count = x.numel() // x.shape[1]
        ctx.dp, ctx.count = dp, count
        if x.is_cuda:
            mean_l, invstd_l = torch.batch_norm_stats(x, BN_EPS)
            both = dp.all_gather(torch.stack([mean_l, invstd_l])[None])  # (world, 2, C)
            # equal counts combine as counts of 1, which the input's dtype
            # (the kernel's) holds exactly
            counts = torch.ones((dp.world,), dtype=x.dtype, device=x.device)
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, both[:, 0], both[:, 1], None, None, 0.0, BN_EPS, counts)
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, BN_EPS)
            var = invstd.pow(-2) - BN_EPS
        else:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32 at least
            var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            both = dp.all_gather(torch.stack([mean_l, var_l])[None])  # (world, 2, C)
            mean = both[:, 0].mean(0)
            var = (both[:, 1] + (both[:, 0] - mean) ** 2).mean(0)
            invstd = torch.rsqrt(var + BN_EPS)
            y = (xf - mean[:, None, None]) * (invstd * weight)[:, None, None] \
                + bias[:, None, None]
            y = y.to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dp, total = ctx.dp, ctx.count * ctx.dp.world
        if x.is_cuda:
            fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) \
                else torch.contiguous_format
            dy = dy.contiguous(memory_format=fmt)
            sum_dy, sum_dy_xmu, d_weight, d_bias = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            sums = dp.all_reduce_(torch.stack([sum_dy, sum_dy_xmu]))
            counts = torch.full((dp.world,), ctx.count, dtype=torch.int32, device=x.device)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sums[0], sums[1],
                                                 counts)
            return dx, d_weight, d_bias, None
        dyf = dy.to(mean.dtype)
        x_hat = (x.to(mean.dtype) - mean[:, None, None]) * invstd[:, None, None]
        sum_dy, sum_dy_xhat = dyf.sum((0, 2, 3)), (dyf * x_hat).sum((0, 2, 3))
        sums = dp.all_reduce_(torch.stack([sum_dy, sum_dy_xhat]))
        mean_dy, mean_dy_xhat = sums[0] / total, sums[1] / total
        dx = (weight * invstd)[:, None, None] * (
            dyf - mean_dy[:, None, None] - x_hat * mean_dy_xhat[:, None, None])
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None


class BatchNorm(nn.Module):
    """BatchNorm with eps 1e-3 and the ultralytics state-dict names (weight,
    bias, running_mean, running_var; no ``num_batches_tracked``, which the
    JAX export does not carry).

    In eval mode it normalises with the running statistics. In train mode it
    is ``flax.linen.BatchNorm(momentum=0.97, epsilon=1e-3)``: it normalises
    with the batch mean and the biased batch variance, and moves the running
    statistics toward those same two (PyTorch's own training-mode
    ``batch_norm`` would move ``running_var`` toward the unbiased variance).
    The statistics are reduced in f32 whatever the input dtype.

    With ``dp`` set (a ``parallel.DataParallel``, by ``TrainState.attach``)
    the batch is the global batch of the data-parallel ranks, as the JAX
    package's BatchNorm under a sharded mesh: ``_SyncBatchNorm``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.update_stats = True  # off while a checkpointed block recomputes
        self.dp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=BN_EPS)
        if self.dp is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.dp)
        else:
            # no running statistics passed: the op leaves them alone and
            # returns the batch mean and 1/sqrt(biased var + eps) it used
            y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                      True, 0.0, BN_EPS)
            var = None
        if not self.update_stats:
            return y
        with torch.no_grad():
            if var is None:
                var = invstd.pow(-2) - BN_EPS
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return y


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
    every chunk (C3k inners when c3k, else Bottlenecks of expansion
    ``inner_e``: 0.5 in yolo11's C3k2, 1.0 in yolov8's C2f, the same CSP)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True, inner_e: float = 0.5):
        super().__init__()
        self.hidden = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.hidden)
        self.cv2 = ConvBN((2 + n) * self.hidden, c2)
        self.m = nn.ModuleList(
            C3k(self.hidden, self.hidden, 2, shortcut) if c3k
            else Bottleneck(self.hidden, self.hidden, shortcut, (3, 3), inner_e)
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


class AAttn(nn.Module):
    """Area attention (yolo12): 1x1 qkv conv, softmax attention within each
    of ``area`` row-major stripes of the H x W tokens, a depthwise 7x7
    positional encoding on V, and a 1x1 projection. Heads are ``dim //
    num_heads`` wide with key_dim = head_dim, so the scale is
    ``head_dim ** -0.5``. Raises ValueError when H*W is not a multiple of
    ``area``."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.area = area
        self.qkv = ConvBN(dim, 3 * dim, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 7, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        n = h * w
        if n % self.area:
            raise ValueError(f"AAttn: {h}x{w}={n} tokens not divisible by area={self.area}")
        qkv = self.qkv(x)
        # (B, C, H, W) -> (B*area, n/area, C): the stripes are contiguous rows
        tokens = qkv.permute(0, 2, 3, 1).reshape(b * self.area, n // self.area, -1).contiguous()
        out, v = area_attention(tokens, self.num_heads, self.head_dim)
        out = out.view(b, h, w, -1).permute(0, 3, 1, 2)
        v = v.view(b, h, w, -1).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    """Area-attention block: AAttn + 1x1-conv MLP, both residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp = nn.Sequential(ConvBN(dim, hidden), ConvBN(hidden, dim, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """R-ELAN stage (yolo12): cv1, then n inner modules on the running tail
    (two ABlocks of hidden // 32 heads each when ``a2``, else one C3k), every
    chunk concatenated into cv2; with ``a2`` and ``residual`` (scales l and
    x) the output is ``x + gamma * out``, gamma a learned per-channel scale
    initialised to 0.01. Raises ValueError when ``a2`` and the hidden width is
    not a multiple of 32."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1,
                 residual: bool = False, mlp_ratio: float = 2.0, e: float = 0.5,
                 shortcut: bool = True):
        super().__init__()
        hidden = int(c2 * e)
        if a2 and hidden % 32:
            raise ValueError(f"A2C2f: hidden dim {hidden} not a multiple of 32")
        self.cv1 = ConvBN(c1, hidden)
        self.cv2 = ConvBN((1 + n) * hidden, c2)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(hidden, hidden // 32, mlp_ratio, area) for _ in range(2)))
            if a2 else C3k(hidden, hidden, 2, shortcut)
            for _ in range(n)
        )
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = [self.cv1(x)]
        for m in self.m:
            chunks.append(m(chunks[-1]))
        out = self.cv2(torch.cat(chunks, 1))
        if self.gamma is None:
            return out
        return x + self.gamma.to(out.dtype).view(-1, 1, 1) * out


@contextlib.contextmanager
def _stats_frozen(module: nn.Module):
    """Inside the block, ``module``'s BatchNorms normalise as in training but
    leave their running statistics alone."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


def rematerialized(module: nn.Module, *args):
    """``module(*args)`` keeping only its inputs for the backward, which runs
    the forward again (``torch.utils.checkpoint``, non-reentrant): the JAX
    package's ``nn.remat``. The recomputation normalises with the same batch
    statistics and does not move the running ones a second time."""
    return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _stats_frozen(module)))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")

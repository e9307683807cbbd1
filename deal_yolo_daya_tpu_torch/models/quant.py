"""Post-training int8 (w8a8) quantization for inference.

The port's copy of ``deal_yolo_daya_tpu/models/quant.py``:

- which convs: every ``ConvBN.conv`` with more than one input channel a
  group (depthwise convs stay full precision), keyed by its module name
  ("1.conv", "23.cv2.0.0.conv", ...); the bare detect-head logit convs
  (``cv2.i.2``, ``cv3.i.2``) are no ``ConvBN`` and stay too;
- activations: a per-conv symmetric scale, ``a_scale = absmax / 127``, the
  running absmax of the conv's input over the calibration batches, taken by
  forward pre-hooks on the BN-folded model (no 1/255 stem fold: it is fed
  ``images / 255``, as the JAX package calibrates);
- weights: per output channel over the BN-folded f32 kernels, in numpy f32
  as JAX does: ``w_scale = w_max / 127`` (1 where ``w_max`` is 0),
  ``w_int8 = clip(round(k / w_scale), -127, 127)``. A conv whose absmax
  stays 0 is left full precision.

A qtree is ``{name: {"w_int8": (O, I, kh, kw) int8, "w_scale": (O,) f32,
"a_scale": () f32}}``. ``quantized_model`` makes a copy of the BN-folded
model in which each quantized conv's ConvBN is an ``Int8ConvBN`` (the s8
conv of ``ops/kernels/int8_conv.py`` with the folded bias and the SiLU in
its epilogue) and which divides its raw 0..255 input by 255 first, so it
stands where the fused predict model stands (``api.infer_fused``, the
Engine's graphs, ``val(int8=True)``).
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Set

import numpy as np
import torch
import torch.nn as nn

from ..ops.kernels import int8_conv as s8
from .blocks import ConvBN


def conv_names(model: nn.Module) -> Set[str]:
    """The convs w8a8 quantizes: every ``ConvBN``'s conv with more than one
    input channel a group, by module name (the JAX ``_conv_paths`` filtered
    by ``kernel.shape[2] > 1``)."""
    return {f"{name}.conv" for name, mod in model.named_modules()
            if isinstance(mod, ConvBN) and mod.conv.in_channels // mod.conv.groups > 1}


@torch.no_grad()
def calibrate(fused: nn.Module, batches: Iterable[torch.Tensor]) -> Dict[str, float]:
    """The running absmax of each quantized conv's input (as f32) over
    ``batches`` (NCHW, already / 255, in the model's dtype), by forward
    pre-hooks on the BN-folded ``fused`` model; one read at the end."""
    names = conv_names(fused)
    amax: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(_, args):
            m = args[0].detach().abs().amax().float()
            amax[name] = m if name not in amax else torch.maximum(amax[name], m)
        return record

    handles = [fused.get_submodule(n).register_forward_pre_hook(hook(n)) for n in names]
    try:
        for x in batches:
            fused(x)
    finally:
        for h in handles:
            h.remove()
    return {n: float(amax[n]) if n in amax else 0.0 for n in names}


def quantize_weight(kernel: torch.Tensor):
    """(O, I, kh, kw) f32 kernel -> (w_int8, w_scale) numpy, per output
    channel, the JAX package's numpy f32 arithmetic."""
    k = kernel.detach().cpu().to(torch.float32).numpy()
    w_max = np.abs(k).reshape(k.shape[0], -1).max(axis=1)
    w_scale = np.where(w_max > 0, w_max / 127.0, 1.0).astype(np.float32)
    w_int8 = np.clip(np.round(k / w_scale[:, None, None, None]), -127, 127).astype(np.int8)
    return w_int8, w_scale


def quantize_int8(fused: nn.Module, batches: Iterable[torch.Tensor],
                  calib_model: nn.Module = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibrate and quantize -> the qtree. ``fused`` is the BN-folded f32
    model (its kernels are quantized); the activations are recorded on
    ``calib_model`` (the same weights in the working dtype and layout; by
    default ``fused`` itself) over ``batches``, NCHW images / 255."""
    absmax = calibrate(fused if calib_model is None else calib_model, batches)
    qtree: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in sorted(absmax):
        if absmax[name] <= 0.0:
            continue  # the conv saw no data: it stays full precision
        w_int8, w_scale = quantize_weight(fused.get_submodule(name).weight)
        qtree[name] = {"w_int8": torch.from_numpy(w_int8), "w_scale": torch.from_numpy(w_scale),
                       "a_scale": torch.tensor(np.float32(absmax[name] / 127.0))}
    return qtree


class Int8ConvBN(nn.Module):
    """A BN-folded ConvBN in w8a8, one kernel launch on the card: the s8
    conv (packed weights and the f32 scales stored once, on the model's
    device), the folded bias and the SiLU when the ConvBN has one, rounded
    in the activations' dtype as the unfused ConvBN rounds them."""

    def __init__(self, convbn: ConvBN, q: Dict[str, torch.Tensor]):
        super().__init__()
        conv = convbn.conv
        k, s = conv.kernel_size, conv.stride
        if conv.groups != 1 or k[0] != k[1] or s[0] != s[1] or conv.padding != (k[0] // 2,) * 2:
            raise ValueError(f"Int8ConvBN: groups 1, square kernel and stride, padding k // 2 "
                             f"(got {conv})")
        if not isinstance(convbn.bn, nn.Identity) or conv.bias is None:
            raise ValueError("Int8ConvBN: the ConvBN must be BN-folded (fuse_conv_bn)")
        a_scale = np.float32(q["a_scale"])
        self.k, self.stride, self.act = k[0], s[0], bool(convbn.act)
        self.inv_a = float(np.float32(1.0) / a_scale)  # f32, as JAX's 1.0 / a_scale
        self.register_buffer("weight", s8.pack_weight(q["w_int8"].to(torch.int8)))
        self.register_buffer("scale", (q["w_scale"].to(torch.float32) *
                                       torch.tensor(a_scale)).contiguous())
        self.register_buffer("bias", conv.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return s8.int8_conv_bn(x, self.weight, self.scale, self.bias, self.inv_a, self.k,
                               self.stride, self.act)


class Int8Detector(nn.Module):
    """The int8 inference model: raw 0..255 NCHW images (the fused model's
    input) divided by 255, then the BN-folded detector with its quantized
    convs."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor):
        return self.net(x / 255.0)


@torch.no_grad()
def quantized_model(fused: nn.Module, qtree: Dict[str, Dict[str, torch.Tensor]],
                    dtype: torch.dtype, device) -> Int8Detector:
    """A copy of the BN-folded ``fused`` model (no 1/255 stem fold) in
    ``dtype`` and channels_last on ``device``, each conv of ``qtree`` an
    ``Int8ConvBN`` in place of the ``ConvBN`` that holds it (the qtree
    keys name the conv, "<ConvBN>.conv", as the JAX module paths do)."""
    net = copy.deepcopy(fused).to(device=device, dtype=dtype,
                                  memory_format=torch.channels_last).eval()
    for name, q in qtree.items():
        convbn, leaf = name.rsplit(".", 1)
        parent, _, child = convbn.rpartition(".")
        owner = net.get_submodule(parent)
        if leaf != "conv" or not isinstance(getattr(owner, child), ConvBN):
            raise ValueError(f"quantized_model: {name} is no ConvBN's conv")
        setattr(owner, child, Int8ConvBN(getattr(owner, child), q).to(device))
    return Int8Detector(net).eval()

"""The yardstick's arithmetic: published peaks, FLOPs of a detector from
its layer shapes, the operations and bytes of the attention and NMS
kernels, rooflines, MFU, and the device's busy time from activity
intervals. Pure functions; no timing here.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W limit
PEAKS = {
    "bf16_flops": 989e12,   # tensor cores, bf16 / fp16
    "f32_flops": 67e12,     # outside the tensor cores
    "hbm_bytes": 3.35e12,   # HBM3
}
# f32 operations of one IoU-and-compare of the NMS suppression test: 2 min,
# 2 max, 2 sub, 2 clamp, 1 mul, 2 add + 1 sub (union + eps), 1 div, 1 compare
IOU_OPS = 14
TRAIN_FLOPS_PER_FORWARD = 3.0  # forward + backward (two products a forward one), no recompute


def conv_flops(cin: int, cout: int, k: int, groups: int, h_out: int, w_out: int) -> float:
    """Multiply-adds x 2 of one conv over one image."""
    return 2.0 * cout * h_out * w_out * (cin // groups) * k * k


def attention_flops(n: int, heads: int, key_dim: int, head_dim: int) -> float:
    """Q K^T and P V of one area of n tokens."""
    return 2.0 * heads * n * n * (key_dim + head_dim)


def attention_fwd_cost(ba: int, n: int, heads: int, key_dim: int, head_dim: int,
                       esize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one forward launch on qkv (ba, n, heads * (2
    key_dim + head_dim)): qkv read once, out and v written once."""
    width = heads * (2 * key_dim + head_dim)
    nbytes = ba * n * (width + 2 * heads * head_dim) * esize
    return ba * attention_flops(n, heads, key_dim, head_dim), float(nbytes)


def attention_bwd_cost(ba: int, n: int, heads: int, key_dim: int, head_dim: int,
                       esize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one backward (both of its kernels): qkv,
    d_out and d_v read, d_qkv written; Q K^T again, dP, dV, dQ, dK."""
    width = heads * (2 * key_dim + head_dim)
    nbytes = ba * n * (2 * width + 2 * heads * head_dim) * esize
    flops = 2.0 * ba * heads * n * n * (3 * key_dim + 2 * head_dim)
    return flops, float(nbytes)


def nms_cost(images: int, valid: int) -> Tuple[float, float]:
    """(operations, bytes) of one suppression launch over ``images`` rows of
    ``valid`` valid candidates each (of 1000 slots): the IoU tests of every
    valid pair, the (B, 1000, 4) f32 boxes and (B, 1000) valid flags in and
    the keep flags out."""
    pairs = images * valid * (valid - 1) / 2.0
    return pairs * IOU_OPS, float(images * 1000 * (16 + 2))


def bound_s(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time the card could take: the larger of operations over the
    peak rate and bytes over HBM bandwidth."""
    return max(flops / flops_peak, nbytes / PEAKS["hbm_bytes"])


def roofline_pct(bound_total_s: float, device_total_s: float) -> Optional[float]:
    """Share of the roofline, in %, or None when nothing ran."""
    if device_total_s <= 0 or bound_total_s <= 0:
        return None
    return 100.0 * bound_total_s / device_total_s


def mfu_pct(flops_per_item: float, items: float, seconds: float,
            peak: float = PEAKS["bf16_flops"]) -> Optional[float]:
    if seconds <= 0 or items <= 0:
        return None
    return 100.0 * flops_per_item * items / seconds / peak


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def model_costs(cfg: Dict, imgsz: int) -> Dict:
    """Forward FLOPs of one image through the reference detector of ``cfg``
    from its layer shapes: every conv (multiply-adds x 2) and the attention
    products, read by forward hooks on a run at ``imgsz`` on the meta
    device. Also the attention calls of one image as (areas, tokens, heads,
    key_dim, head_dim). Elementwise work, pooling and upsampling are not
    counted."""
    import torch

    from ..reference import model as ref

    convs: List[float] = []
    attn: List[Tuple] = []

    def conv_hook(mod, inp, out):
        convs.append(conv_flops(mod.in_channels, mod.out_channels, mod.kernel_size[0],
                                mod.groups, out.shape[2], out.shape[3]))

    def attn_hook(mod, inp, out):
        _, c, h, w = inp[0].shape
        if isinstance(mod, ref.Attention):
            attn.append((1, h * w, mod.num_heads, mod.key_dim, mod.head_dim))
        else:
            attn.append((mod.area, h * w // mod.area, mod.num_heads, mod.head_dim,
                         mod.head_dim))

    with torch.device("meta"):
        model = ref.Detector(cfg).eval()
    handles = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            handles.append(mod.register_forward_hook(conv_hook))
        elif isinstance(mod, (ref.Attention, ref.AAttn)):
            handles.append(mod.register_forward_hook(attn_hook))
    try:
        with torch.no_grad():
            model(torch.zeros((1, 3, imgsz, imgsz), device="meta"))
    finally:
        for h in handles:
            h.remove()
    attn_flops = sum(a * attention_flops(n, h, kd, hd) for a, n, h, kd, hd in attn)
    return {"conv_flops": sum(convs), "attention_flops": attn_flops,
            "forward_flops": sum(convs) + attn_flops, "attention_calls": attn,
            "convs": len(convs)}


def attention_step_cost(calls: Sequence[Tuple], batch: int, backward: bool) -> Tuple[float, int]:
    """(bound seconds, launches) of one batch's attention calls of one
    direction: each call a launch over ``batch`` x areas rows."""
    total, n_launch = 0.0, 0
    for a, n, h, kd, hd in calls:
        cost = attention_bwd_cost if backward else attention_fwd_cost
        flops, nbytes = cost(batch * a, n, h, kd, hd)
        total += bound_s(flops, nbytes, PEAKS["bf16_flops"])
        n_launch += 1
    return total, n_launch

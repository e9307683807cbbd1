"""The arithmetic of the YOLOv10 reference (``reference/yolov10.py``): its
FLOPs from layer shapes and its attention calls, by ``lib/arith.py``'s pure
functions. ``arith.model_costs`` builds ``reference/model.py``'s detector,
which has no YOLOv10; this is its counterpart. Pure arithmetic, no timing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import arith


def v10_costs(cfg: Dict, imgsz: int, train: bool = True) -> Dict:
    """Forward FLOPs of one image through the YOLOv10 reference of ``cfg``
    at ``imgsz``: every conv (multiply-adds x 2) and the attention products,
    read by forward hooks on a run on the meta device. ``train`` runs the
    training forward (both heads); else the deployed one (the one-to-one
    head alone). Also the attention calls of one image as (areas, tokens,
    heads, key_dim, head_dim). Elementwise work, pooling and upsampling are
    not counted."""
    import torch

    from ..reference import yolov10 as ref

    convs: List[float] = []
    attn: List[Tuple] = []

    def conv_hook(mod, inp, out):
        convs.append(arith.conv_flops(mod.in_channels, mod.out_channels, mod.kernel_size[0],
                                      mod.groups, out.shape[2], out.shape[3]))

    def attn_hook(mod, inp, out):
        _, _, h, w = inp[0].shape
        attn.append((1, h * w, mod.num_heads, mod.key_dim, mod.head_dim))

    with torch.device("meta"):
        model = ref.Detector(cfg).train(train)
    handles = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            handles.append(mod.register_forward_hook(conv_hook))
        elif isinstance(mod, ref.Attention):
            handles.append(mod.register_forward_hook(attn_hook))
    try:
        with torch.no_grad():
            model(torch.zeros((1, 3, imgsz, imgsz), device="meta"))
    finally:
        for h in handles:
            h.remove()
    attn_flops = sum(a * arith.attention_flops(n, h, kd, hd) for a, n, h, kd, hd in attn)
    return {"conv_flops": sum(convs), "attention_flops": attn_flops,
            "forward_flops": sum(convs) + attn_flops, "attention_calls": attn,
            "convs": len(convs)}

#!/usr/bin/env python3
"""Time the s8 ConvBN's routes at every quantized conv of a yolo11n b32 batch.

    python3 tools/time_int8_conv_torch.py [--seed N] [--batch 32] [--imgsz 640]
        [--stages 1,2,3,4] [--out runs/int8_conv_routes.json]

Runs on one CUDA card. The shapes are those of the 74 convs that
``quantize_int8`` makes int8 in yolo11n (forward pre-hooks on the BN-folded
bf16 model, channels_last): each input's channels, size, pixel stride and
channel offset (a C2f/C3k2 split is a channel slice, read in place), the
output channels, kernel and stride. For each conv, on random bf16 inputs of
that layout and random int8 weights, scaled so that the pre-activation
spreads as a trained model's does:

- every route the shape allows (``ops/kernels/int8_conv.py::plan``): the
  TMA ring at each of ``--stages`` that fits in shared memory, the same
  kernel with its threads' own 16-byte loads (``direct``), or the mma.sync
  ``narrow`` kernel, each checked bit for bit against the plain version
  (s32 sums and output) on the first two images;
- the default route once more without the SiLU (``default_noact``): what
  the exact SiLU costs in the epilogue;
- its device time: CUDA events around a CUDA graph of 10 launches
  (``chip_smoke.graph_time_ms``), and cuDNN's bf16 conv of the same shape
  beside it; the bound as ``chip_smoke.s8_bound`` counts it.

Then the host time of one eager call of each route on a 1 x 16 x 8 x 8 input
(the device time negligible), which holds the tensor map's encoding for the
TMA route. Prints the card, a line per conv and one JSON object, and writes
the JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def path_conv_shapes(imgsz: int):
    """(name, C, H, W, ldc, channel offset, Cout, k, s) of each quantized
    conv's input in the bf16 channels_last model at batch 1."""
    import torch

    from deal_yolo_daya_tpu_torch.models import make_detector, quant
    from deal_yolo_daya_tpu_torch.models.yolo11 import fuse_conv_bn
    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic

    model = fuse_conv_bn(make_detector("yolo11", "n", 80).eval()).to(
        device="cuda", dtype=torch.bfloat16, memory_format=torch.channels_last)
    rows = []

    def hook(name):
        def record(mod, args):
            x = args[0]
            ldc = ic.pixel_stride(x) or x.shape[1]
            rows.append((name, x.shape[1], x.shape[2], x.shape[3], ldc,
                         x.storage_offset() % ldc, mod.out_channels, mod.kernel_size[0],
                         mod.stride[0]))
        return record

    handles = [model.get_submodule(n).register_forward_pre_hook(hook(n))
               for n in sorted(quant.conv_names(model))]
    with torch.no_grad():
        model(torch.zeros(1, 3, imgsz, imgsz, device="cuda", dtype=torch.bfloat16))
    for h in handles:
        h.remove()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--stages", default="1,2,3,4")
    ap.add_argument("--out", default=str(ROOT / "runs" / "int8_conv_routes.json"))
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from chip_smoke import graph_time_ms, s8_bound, same_bits
    from deal_yolo_daya_tpu_torch.ops.kernels import _build
    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0].strip()
    print(card)
    for line in _build.build(["int8_conv"]).get("int8_conv", "").splitlines():
        if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
            print(line.strip()[:140])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stages = [int(s) for s in args.stages.split(",")]
    rows = []
    for name, c, h, w, ldc, off, n, k, s in path_conv_shapes(args.imgsz):
        # activations of unit spread quantized at a_scale 4/127 (steps of
        # spread ~32), uniform int8 weights (spread ~73), and per-channel
        # scales that put the ConvBN's pre-activation at a spread of ~3, as a
        # trained model's are: a spread far wider sends the SiLU's division
        # down its slow path (a divisor 1 + exp(-z) past 2^126) far more often
        # than real data does
        full = torch.randn((args.batch, h, w, ldc), generator=gen, device="cuda").to(
            torch.bfloat16)
        x = full[..., off:off + c].permute(0, 3, 1, 2)
        wq = torch.randint(-127, 128, (n, c, k, k), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        packed = ic.pack_weight(wq)
        acc_spread = (k * k * c) ** 0.5 * 32 * 73
        scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) * (3.0 / acc_spread)
        bias = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        inv_a = 127.0 / 4.0
        plans = {}
        for st in stages:
            pl = ic.plan(c, n, k, s, 2, True, st, False)
            if pl.route == "tma" and pl.stages == st:
                plans[f"tma{st}"] = pl
        direct = ic.plan(c, n, k, s, 2, False)
        plans[direct.route] = direct
        few = x[:2]
        yp, accp = ic.int8_conv_bn_plain(few, packed, scale, bias, inv_a, k, s, True)
        times = {}
        for label, pl in plans.items():
            y, acc = ic.launch(few, packed, scale, bias, inv_a, k, s, True, with_acc=True, use=pl)
            torch.cuda.synchronize()
            if not (same_bits(acc, accp.to(acc.dtype)) and same_bits(y, yp)):
                print(f"{name} {label}: differs from the plain version", file=sys.stderr)
                return 1
            times[label] = graph_time_ms(
                lambda pl=pl: ic.launch(x, packed, scale, bias, inv_a, k, s, True, use=pl),
                calls=10)
        default = ic.plan(c, n, k, s)
        times["default_noact"] = graph_time_ms(
            lambda: ic.launch(x, packed, scale, bias, inv_a, k, s, False, use=default), calls=10)
        wb = ic.unpack_weight(packed, c, k).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        xc = x.contiguous(memory_format=torch.channels_last)
        times["cudnn_bf16"] = graph_time_ms(lambda: F.conv2d(xc, wb, stride=s, padding=k // 2),
                                            calls=10)
        bound = s8_bound((args.batch, c, h, w), n, k, s, 2)[0]
        rows.append({"conv": name, "shape": [args.batch, c, h, w, n, k, s], "ldc": ldc,
                     "offset": off, "default": default.route + (
                         str(default.stages) if default.route == "tma" else ""),
                     "nt": default.nt, "smem": default.nbytes, "bound_ms": bound, "ms": times})
        print(f"{name} {(args.batch, c, h, w)} -> {n} k{k} s{s} ldc {ldc}: " + "; ".join(
            f"{key} {v:.4f}" for key, v in times.items()) + f"; bound {bound:.4f} ms")

    def total(key_of):
        return sum(key_of(r) for r in rows)

    labels = sorted({key for r in rows for key in r["ms"]})
    sums = {"default": total(lambda r: r["ms"][r["default"]]),
            "bound": total(lambda r: r["bound_ms"]),
            "best": total(lambda r: min(v for key, v in r["ms"].items()
                                        if key not in ("cudnn_bf16", "default_noact")))}
    for label in labels:  # over the convs that route can take, beside the default there
        have = [r for r in rows if label in r["ms"]]
        sums[label] = {"convs": len(have), "ms": sum(r["ms"][label] for r in have),
                       "default_ms": sum(r["ms"][r["default"]] for r in have)}

    # host time of one eager call, the device time negligible
    host = {}
    x = torch.randn((1, 8, 8, 16), device="cuda").to(torch.bfloat16).permute(0, 3, 1, 2)
    packed = ic.pack_weight(torch.ones((16, 16, 3, 3), dtype=torch.int8, device="cuda"))
    scale = torch.full((16,), 1e-3, device="cuda")
    bias = torch.zeros(16, device="cuda", dtype=torch.bfloat16)
    for label, pl in (("tma", ic.plan(16, 16, 3, 1)), ("direct", ic.plan(16, 16, 3, 1, 2, False))):
        for _ in range(20):
            ic.launch(x, packed, scale, bias, 20.0, 3, 1, True, use=pl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            ic.launch(x, packed, scale, bias, 20.0, 3, 1, True, use=pl)
        host[label] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    record = {"card": card, "batch": args.batch, "imgsz": args.imgsz, "convs": len(rows),
              "sums_ms": sums, "host_us_per_call": host, "rows": rows}
    print(f"sums over {len(rows)} convs (ms): " + json.dumps(sums))
    print(f"host us a call: {host}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"sums_ms": sums, "host_us_per_call": host, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

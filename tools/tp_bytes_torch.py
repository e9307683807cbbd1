#!/usr/bin/env python3
"""The bytes tensor parallelism moves in one train step, counted from shapes.

    python3 tools/tp_bytes_torch.py [--model yolo11n] [--imgsz 640] [--batch 16]
                                    [--n-model 2] [--min-channels 256]

For each conv that ``tp_param_shardings`` picks, the activation shapes of a
CPU forward at batch 1 (scaled to ``--batch`` rows of a data index) give, a
rank and a step in bf16: the forward all_gather of the output channels
((M - 1) / M of the output received) and the backward SUM of the input
gradient (a ring all-reduce sends and receives 2 (M - 1) / M of it). Then
the f32 broadcast of the replicated gradients once an update and the
model's whole parameters. A count of bytes, on the CPU: no time.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from deal_yolo_daya_tpu_torch.models.registry import make_detector, parse_model_spec  # noqa: E402
from deal_yolo_daya_tpu_torch.parallel.sharding import tp_param_shardings  # noqa: E402

BF16 = 2


def count(model_spec: str, imgsz: int, batch: int, n_model: int, min_channels: int):
    family, scale = parse_model_spec(model_spec)
    model = make_detector(family, scale, 80).eval()
    sharded = tp_param_shardings(model, n_model, min_channels)
    shapes = {}

    def hook(name):
        def run(mod, inputs, output):
            shapes[name] = (tuple(inputs[0].shape), tuple(output.shape))
        return run

    for name in sharded:
        model.get_submodule(name.rsplit(".", 1)[0]).register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.zeros(1, 3, imgsz, imgsz))
    share = (n_model - 1) / n_model
    rows = []
    for name, (inp, out) in shapes.items():
        out_b = batch * out[1] * out[2] * out[3] * BF16
        in_b = batch * inp[1] * inp[2] * inp[3] * BF16
        rows.append({"conv": name.rsplit(".", 1)[0], "in": [batch, *inp[1:]], "out": [batch, *out[1:]],
                     "gather_bytes": share * out_b, "input_grad_sum_bytes": 2 * share * in_b})
    n_params = sum(p.numel() for p in model.parameters())
    n_sharded = sum(model.get_parameter(n).numel() for n in sharded)
    return {"model": model_spec, "imgsz": imgsz, "batch": batch, "n_model": n_model,
            "min_channels": min_channels, "convs": rows,
            "gather_bytes": sum(r["gather_bytes"] for r in rows),
            "input_grad_sum_bytes": sum(r["input_grad_sum_bytes"] for r in rows),
            "replicated_grad_broadcast_bytes": 4 * (n_params - n_sharded),
            "params": n_params, "sharded_params": n_sharded}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolo11n")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-model", type=int, default=2)
    ap.add_argument("--min-channels", type=int, default=256)
    args = ap.parse_args()
    out = count(args.model, args.imgsz, args.batch, args.n_model, args.min_channels)
    for r in out["convs"]:
        print(f"{r['conv']:28s} in {r['in']} out {r['out']}: gather "
              f"{r['gather_bytes'] / 1e6:.3f} MB, input-gradient SUM "
              f"{r['input_grad_sum_bytes'] / 1e6:.3f} MB")
    print(json.dumps({k: v for k, v in out.items() if k != "convs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

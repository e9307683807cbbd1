#!/usr/bin/env python3
"""Time the port's CUDA kernels and their library calls on one card.

    python3 tools/time_attention_kernels.py [--package-root DIR ...] [--seed N]
        [--kernels attention,nms,score_reduce]

For each ``--package-root`` (a directory holding ``deal_yolo_daya_tpu_torch``;
default: this repository), in the order given, it builds the kernels named
by ``--kernels`` (default: attention), checks each against its plain version
and against itself (two launches bit-identical), and times it at the main
paths' shapes:

- ``attention``: the bf16 forward and backward at yolo11n's C2PSA shape,
  (32, 400, 256) with 2 heads, key_dim 32, head_dim 64, beside
  ``scaled_dot_product_attention`` forward and its backward alone
  (``torch.autograd.grad`` on a kept graph);
- ``nms``: the suppression at predict's (32, 1000, 4), dense class-offset
  scenes with every candidate valid, iou 0.7; where the root's wrapper takes
  clock stamps (``launch(..., stamps)``), the walking CTAs' SM clocks split
  the device time into the mask phase (until the last row tile of the
  bitmask is in) and the walk's tail after it;
- ``score_reduce``: (32, 8400, 80) logits in bf16 and f32, by the mapping
  the root picks and, where the root has ``reduce_mapping``, by each other
  mapping the layout allows, beside ``torch.max`` + sigmoid.

Each is timed as

- ``device_ms``: the device time per call under ``torch.profiler``, the sum
  of ``self_device_time_total`` over the kernels launched in a window of 50
  calls, over the number of calls (``chip_smoke.device_time_ms``);
- ``call_ms``: CUDA events around 200 back-to-back calls, host time
  included (what a call costs the caller).

Give two roots twice (``--package-root A --package-root B --package-root B
--package-root A``) to compare two versions in one process on one card. Each
root is imported in a fresh subprocess. Prints one JSON line per root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def timed(fn) -> dict:
    from chip_smoke import cuda_time_ms, device_time_ms

    ms, per_kernel = device_time_ms(fn)
    return {"device_ms": ms, "call_ms": cuda_time_ms(fn, 200),
            "kernels": {k[:90]: v for k, v in per_kernel.items()}}


def attention_record(seed: int) -> dict:
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ba, n, heads, kd, hd = 32, 400, 2, 32, 64
    qkv = torch.randn((ba, n, heads * (2 * kd + hd)), generator=gen, device=dev).bfloat16()
    # cotangents at the train path's scale (~1e-3)
    d_out, d_v = ((1e-3 * torch.randn((ba, n, heads * hd), generator=gen, device=dev)).bfloat16()
                  for _ in range(2))
    a = (heads, hd, kd)

    out, v = aa.area_attention_fwd(qkv, *a)
    out2, _ = aa.area_attention_fwd(qkv, *a)
    ref_out, ref_v = aa.area_attention_plain(qkv, *a)
    dq = aa.area_attention_bwd(qkv, d_out, d_v, *a)
    dq2 = aa.area_attention_bwd(qkv, d_out, d_v, *a)
    ref_dq = aa.area_attention_bwd_plain(qkv, d_out, d_v, *a)
    torch.cuda.synchronize()
    scale = ref_dq.float().abs().max().item()
    checks = {
        "fwd_max_abs_err": (out.float() - ref_out.float()).abs().max().item(),
        "fwd_v_exact": bool(torch.equal(v, ref_v)),
        "fwd_deterministic": bool(torch.equal(out, out2)),
        "bwd_max_abs_err": (dq.float() - ref_dq.float()).abs().max().item(),
        "bwd_plain_max": scale,
        "bwd_deterministic": bool(torch.equal(dq, dq2)),
    }

    split = qkv.view(ba, n, heads, 2 * kd + hd)
    q, k, vv = (t.transpose(1, 2) for t in (split[..., :kd], split[..., kd:2 * kd],
                                            split[..., 2 * kd:]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.contiguous().requires_grad_() for t in (q, k, vv))
    sdpa_out = sdpa(qg, kg, vg)
    sdpa_grad = d_out.view(ba, n, heads, hd).transpose(1, 2).contiguous()

    def fwd():
        aa.area_attention_fwd(qkv, *a)

    def bwd():
        aa.area_attention_bwd(qkv, d_out, d_v, *a)

    def lib_fwd():
        sdpa(q, k, vv)

    def lib_bwd():
        torch.autograd.grad(sdpa_out, (qg, kg, vg), sdpa_grad, retain_graph=True)

    rec = {"checks": checks}
    for name, fn in (("fwd", fwd), ("bwd", bwd), ("sdpa_fwd", lib_fwd), ("sdpa_bwd", lib_bwd)):
        rec[name] = timed(fn)
    return rec


def nms_phases(device_ms: float, cycles) -> dict:
    """The NMS kernel's device time split by its walking CTAs' mean SM
    clocks (to the last row tile's arrival, the whole kernel, the walker's
    wait for tiles): the mask phase, the walk's tail after it, and the share
    of the kernel the walk spent waiting for the mask."""
    mask_end, total, waited = cycles
    return {"mask": device_ms * mask_end / total,
            "walk_tail": device_ms * (total - mask_end) / total,
            "walk_waiting_share": waited / total}


def nms_record(seed: int) -> dict:
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (32, 1000, 2))
    wh = rng.uniform(8, 200, (32, 1000, 2))
    offset = rng.integers(0, 3, (32, 1000, 1)) * 7680.0
    boxes = torch.tensor(np.concatenate([xy, xy + wh], -1) + offset, dtype=torch.float32,
                         device=dev)
    valid = torch.ones((32, 1000), dtype=torch.bool, device=dev)
    thr = 0.7
    keep, keep2 = ns.nms_suppress(boxes, valid, thr), ns.nms_suppress(boxes, valid, thr)
    ref = ns.nms_suppress_plain(boxes, valid, thr)
    torch.cuda.synchronize()
    rec = {"checks": {"mismatched_bits": int((keep != ref).sum()),
                      "deterministic": bool(torch.equal(keep, keep2)), "kept": int(keep.sum())},
           "nms": timed(lambda: ns.nms_suppress(boxes, valid, thr))}
    if hasattr(ns, "launch"):  # the clustered design: split by the SM clock stamps
        stamps = torch.zeros((32, 3), dtype=torch.int64, device=dev)
        ns.launch(boxes, valid, thr, stamps)
        torch.cuda.synchronize()
        mean = stamps.double().mean(0).tolist()
        # newer roots take the card's cluster counts as an argument, older ones none
        geometry = (ns.nms_geometry(32, 1000, ns.active_clusters())
                    if hasattr(ns, "active_clusters") else ns.nms_geometry(32, 1000))
        rec["geometry"] = geometry._asdict()
        rec["max_active_clusters"] = ns.max_active_clusters(geometry)
        rec["stamps_mean_cycles"] = mean
        rec["phase_device_ms"] = nms_phases(rec["nms"]["device_ms"], mean)
    return rec


def score_reduce_record(seed: int) -> dict:
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import score_reduce as sr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec = {}
    for dt in (torch.bfloat16, torch.float32):
        x = (torch.randn((32, 8400, 80), generator=gen, device=dev) * 2 - 3).to(dt)
        ref = sr.score_reduce_plain(x)
        runs = {"default": lambda: sr.score_reduce(x)}
        if hasattr(sr, "reduce_mapping"):
            for m in ("bulk_rows", "warp_rows"):
                runs[m] = (lambda m=m: sr.launch(x, m))
        name = str(dt).split(".")[-1]
        for label, fn in runs.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            rec[f"{name}_{label}"] = {"equal_to_plain": same,
                                      "deterministic": all(torch.equal(g, h)
                                                           for g, h in zip(got, again)),
                                      **timed(fn)}
        rec[f"{name}_torch_max_sigmoid"] = timed(
            lambda: torch.sigmoid(torch.max(x, dim=-1).values.float()))
    return rec


RECORDS = {"attention": (("area_attention", "area_attention_bwd"), attention_record),
           "nms": (("nms_suppress",), nms_record),
           "score_reduce": (("score_reduce",), score_reduce_record)}


def run_one(root: Path, seed: int, kernels) -> dict:
    import torch

    sys.path.insert(0, str(root))
    sys.path.append(str(ROOT))
    from deal_yolo_daya_tpu_torch.ops.kernels import _build

    sources = [s for k in kernels for s in RECORDS[k][0]]
    logs = _build.build(sources)
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if any(w in ln for w in ("registers", "spill", "Compiling"))]
    rec = {"root": str(root), "card": torch.cuda.get_device_name(0), "ptxas": ptxas}
    for k in kernels:
        rec[k] = RECORDS[k][1](seed)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", action="append", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="attention",
                    help="comma-separated: " + ", ".join(RECORDS))
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = [k for k in kernels if k not in RECORDS]
    if unknown:
        ap.error(f"unknown --kernels {unknown}; choose from {list(RECORDS)}")
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve(), args.seed, kernels)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    rc = 0
    for root in args.package_root or [ROOT]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root), "--seed",
                               str(args.seed), "--kernels", args.kernels], timeout=600)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

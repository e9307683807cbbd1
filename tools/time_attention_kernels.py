#!/usr/bin/env python3
"""Time the area-attention CUDA kernels and their library calls on one card.

    python3 tools/time_attention_kernels.py [--package-root DIR ...] [--seed N]

For each ``--package-root`` (a directory holding ``deal_yolo_daya_tpu_torch``;
default: this repository), in the order given, it builds the kernels, checks
the bf16 forward and backward against their plain versions and against
themselves (two launches bit-identical), and times them at yolo11n's C2PSA
shape, (32, 400, 256) bf16 with 2 heads, key_dim 32, head_dim 64:

- ``device_ms``: the device time per call under ``torch.profiler``, the sum
  of ``self_device_time_total`` over the kernels launched in a window of 50
  calls, over the number of calls (``chip_smoke.device_time_ms``);
- ``call_ms``: CUDA events around 200 back-to-back calls, host time
  included (what a call costs the caller);
- the same two for ``scaled_dot_product_attention`` forward, and for its
  backward alone (``torch.autograd.grad`` on a kept graph).

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


def run_one(root: Path, seed: int) -> dict:
    import torch

    sys.path.insert(0, str(root))
    sys.path.append(str(ROOT))
    from chip_smoke import cuda_time_ms, device_time_ms
    from deal_yolo_daya_tpu_torch.ops.kernels import _build
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa

    logs = _build.build(["area_attention", "area_attention_bwd"])
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if any(w in ln for w in ("registers", "spill", "Compiling"))]
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

    rec = {"root": str(root), "card": torch.cuda.get_device_name(0), "checks": checks,
           "ptxas": ptxas}
    for name, fn in (("fwd", fwd), ("bwd", bwd), ("sdpa_fwd", lib_fwd), ("sdpa_bwd", lib_bwd)):
        ms, per_kernel = device_time_ms(fn)
        rec[name] = {"device_ms": ms, "call_ms": cuda_time_ms(fn, 200),
                     "kernels": {k[:90]: v for k, v in per_kernel.items()}}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", action="append", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve(), args.seed)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    rc = 0
    for root in args.package_root or [ROOT]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root), "--seed",
                               str(args.seed)], timeout=600)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

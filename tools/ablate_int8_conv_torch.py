#!/usr/bin/env python3
"""Where the s8 ConvBN's time goes: its wgmma kernel with parts switched off.

    python3 tools/ablate_int8_conv_torch.py [--seed N]
        [--out runs/int8_conv_ablation.json]

Runs on one CUDA card. It copies ``csrc/int8_conv.cu`` into
``deal_yolo_daya_tpu_torch/_build/ablate/`` with a compile-time switch
``ABL`` (bits: 1 the epilogue's stores, 2 the quantizer, 4 the products, 16
the TMA loads and their waits), builds one library a variant with the
repository's flags (all ``nvcc`` at once) and times each variant of the
TMA route, and the full kernel of the direct route, by CUDA events around
a CUDA graph of 10 launches (``chip_smoke.graph_time_ms``) at six of
yolo11n's b32 convs, with and without the SiLU. A variant computes
garbage: it only says what the part it drops costs where the others stay
(the parts overlap, so the differences do not add up). A text the copy
switches that is no longer in the source fails loudly: update it with the
kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (text of the kernel, the same with the switch)
SWITCHES = [
    ('#include "hopper.cuh"', '#include "hopper.cuh"\n#ifndef ABL\n#define ABL 0\n#endif'),
    ("      mbar_wait(bars + 8 * s, (j / stages) & 1);\n"
     "      quantize_stage<T, TH>(p, smem + s * p.plan[P_STAGE], qt, a_tile, items);",
     "      if (!(ABL & 16)) mbar_wait(bars + 8 * s, (j / stages) & 1);\n"
     "      if (!(ABL & 2))\n"
     "        quantize_stage<T, TH>(p, smem + s * p.plan[P_STAGE], qt, a_tile, items);"),
    ("  if (LOAD == BY_TMA && tid == 0)\n    for (int j = 0; j < stages && j < count; ++j)",
     "  if (LOAD == BY_TMA && tid == 0 && !(ABL & 16))\n"
     "    for (int j = 0; j < stages && j < count; ++j)"),
    ("    if (LOAD == BY_TMA && tid == 0 && j + stages < count)",
     "    if (LOAD == BY_TMA && tid == 0 && j + stages < count && !(ABL & 16))"),
    ("    for (int i = 0; i < steps; ++i) {\n      const uint2 t = tab[i];",
     "    if (ABL & 4)\n      for (int i = 0; i < NW / 2; ++i) acc[i] = i;\n"
     "    for (int i = 0; i < ((ABL & 4) ? 0 : steps); ++i) {\n      const uint2 t = tab[i];"),
    ("        write_pair<T>(p.out, rows[half], n0 + c, epilogue<T>(a0, s2.x, b2.x, p.out.act),\n"
     "                      epilogue<T>(a1, s2.y, b2.y, p.out.act), a0, a1);",
     "        const float v0 = epilogue<T>(a0, s2.x, b2.x, p.out.act);\n"
     "        const float v1 = epilogue<T>(a1, s2.y, b2.y, p.out.act);\n"
     "        if (!(ABL & 1) || (v0 == 1234.5f && v1 == 77.25f))  // kept, never stored\n"
     "          write_pair<T>(p.out, rows[half], n0 + c, v0, v1, a0, a1);"),
]
VARIANTS = {"full": 0, "no_store": 1, "no_quantize": 2, "no_products": 4, "no_loads": 16,
            "no_quantize_loads": 18, "no_store_quantize_loads": 19,
            "epilogue_and_stores": 22, "epilogue_only": 23}
# (B, Cin, H, W, Cout, k, stride): the heaviest conv, the slowest 1x1, a 3x3
# at 80 x 80, a wide 1x1 at 20 x 20, a 1x1 at 80 x 80, the second conv
SHAPES = [(32, 64, 160, 160, 64, 3, 2), (32, 48, 160, 160, 64, 1, 1), (32, 64, 80, 80, 64, 3, 1),
          (32, 256, 20, 20, 256, 1, 1), (32, 64, 80, 80, 64, 1, 1), (32, 16, 320, 320, 32, 3, 2)]


def build(variants):
    from deal_yolo_daya_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "int8_conv.cu").read_text()
    for old, new in SWITCHES:
        if old not in src:
            raise SystemExit(f"the kernel no longer holds {old[:60]!r}: update SWITCHES")
        src = src.replace(old, new)
    out = _build.BUILD / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    (out / "int8_conv_ablate.cu").write_text(src)
    nvcc = _build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.ARCH, *[f for f in _build.COMMON if f not in ("-Xptxas", "-v")],
         "-I", str(_build.CSRC), f"-DABL={bits}", "-o", str(out / f"lib_{name}.so"),
         str(out / "int8_conv_ablate.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, bits in variants.items()}
    funcs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(out / f"lib_{name}.so")).s8_conv_wgmma
        from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic

        fn.argtypes, fn.restype = ic._WGMMA_ARGS, ctypes.c_int
        funcs[name] = fn
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "runs" / "int8_conv_ablation.json"))
    args = ap.parse_args()

    import torch

    from chip_smoke import graph_time_ms
    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0].strip()
    print(card)
    funcs = build(VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for b, c, h, w, n, k, s in SHAPES:
        # the timing tool's data: pre-activations spread as a trained model's
        x = torch.randn((b, h, w, c), generator=gen, device=dev).to(torch.bfloat16).permute(
            0, 3, 1, 2)
        wq = torch.randint(-127, 128, (n, c, k, k), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        packed = ic.pack_weight(wq)
        scale = (0.5 + torch.rand(n, generator=gen, device=dev)) * 3.0 / (
            (k * k * c) ** 0.5 * 32 * 73)
        bias = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        ho, wo = ic.out_size(h, k, s), ic.out_size(w, k, s)
        y = torch.empty((b, ho, wo, n), dtype=torch.bfloat16, device=dev)
        times = {}
        for route, pl in (("tma", ic.plan(c, n, k, s)), ("direct", ic.plan(c, n, k, s, 2, False))):
            ints = ic._plan_ints(pl)
            for name, fn in funcs.items():
                if route == "direct" and name != "full":
                    continue
                for act in (1, 0):
                    def call(fn=fn, ints=ints, act=act):
                        err = fn(x.data_ptr(), 1, b, h, w, c, c, packed.data_ptr(), n, k, s,
                                 packed.shape[1], 31.75, scale.data_ptr(), bias.data_ptr(), act,
                                 y.data_ptr(), None, ho, wo, ints,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{route} {name}: CUDA error {err}")
                    key = f"{route} {name}" + ("" if act else " no SiLU")
                    times[key] = graph_time_ms(call, calls=10)
        rows.append({"shape": [b, c, h, w, n, k, s], "stages": ic.plan(c, n, k, s).stages,
                     "ms": times})
        print(f"{(b, c, h, w)} -> {n} k{k} s{s}: " + "; ".join(
            f"{key} {v:.4f}" for key, v in times.items()), flush=True)
    record = {"card": card, "variants": VARIANTS, "rows": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"card": card, "shapes": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

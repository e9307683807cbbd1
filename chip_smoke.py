#!/usr/bin/env python3
"""Drive the PyTorch port's yolo11n predict on one NVIDIA card and hold its
CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card and nvcc. Phases:

1. environment: card name and power limit, torch and CUDA versions;
2. build: every kernel under ``deal_yolo_daya_tpu_torch/csrc`` is compiled
   (all nvcc processes at once) and ptxas' registers, shared memory and spills
   are printed;
3. attention kernel vs plain: yolo11n's C2PSA shape (32 x 400 tokens, 2
   heads, key_dim 32, head_dim 64) and the ragged 35 and 1600 tokens, in bf16
   and f32, at stated tolerances; ``v`` exact;
4. NMS kernel vs plain: dense class-offset scenes, B=32, K=1000, at iou 0.45
   and 0.7; the keep masks must be bit-identical;
5. predict, the main path: ``YOLO("yolo11n", nc=80, imgsz=640)`` with random
   weights from ``--seed`` predicts 64 numpy-made images of mixed sizes at
   batch 32 and conf 0.001, in bf16. The launch counts are set to 0 just
   before and read just after; the kernels' inputs on that path are recorded
   and both kernels are held against their plain versions on them. Then, in
   f32 with TF32 off, the decoded (boxes, scores) before NMS through the
   kernel against the same path through the plain attention;
6. times: each kernel (CUDA events, warm, many launches) at the main path's
   inputs, its plain version, its bound from the shapes, the library call
   where one exists; predict's end-to-end img/s with the host letterbox and
   the device work apart;
7. profile: one predict under torch.profiler, the device's busy share and the
   kernels that take its time.

Any failure raises and exits non-zero. On success the second-to-last line is
the JSON ``kernels`` record and the last line the device record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# f32 operations in one IoU-and-compare of the suppression test: 2 min,
# 2 max, 2 sub, 2 clamp, 1 mul (intersection), 2 add + 1 sub (union + eps),
# 1 div, 1 compare
IOU_OPS = 14

ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PRED_TOL = {"boxes_px": 1e-2, "scores": 1e-4}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def patched(module, name, value):
    """Swap ``module.name`` for ``value`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_images(seed: int, count: int):
    """Mixed-size RGB uint8 images: smooth colour fields plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = []
    for _ in range(count):
        h, w = int(rng.integers(240, 1081)), int(rng.integers(240, 1081))
        base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
        img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w]
        noise = rng.integers(-20, 21, (h, w, 3))
        images.append(np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return images


def zero_class_bias(yolo) -> None:
    """At the class prior log(5/80/6400) ~ -11.5, random-weight scores are
    ~1e-5 and conf 0.001 passes nothing; with zero class biases every anchor
    passes and NMS sees a dense K=1000 candidate set."""
    import torch

    with torch.no_grad():
        for branch in yolo._ensure_built().layer(23).cv3:
            branch[2].bias.zero_()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import deal_yolo_daya_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script: {e}",
              file=sys.stderr)
        return 1
    import numpy as np

    from deal_yolo_daya_tpu_torch.api import YOLO
    from deal_yolo_daya_tpu_torch.models import blocks
    from deal_yolo_daya_tpu_torch.ops import nms as nms_ops
    from deal_yolo_daya_tpu_torch.ops.decode import decode_predictions
    from deal_yolo_daya_tpu_torch.ops.kernels import _build
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.ops.letterbox import letterbox_numpy

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(_build.EXTRA)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(_build.EXTRA):
        lines = [ln.strip() for ln in logs.get(name, "(already built)").splitlines()
                 if any(w in ln for w in ("registers", "spill", "smem", "Compiling", "built"))]
        for ln in lines:
            log(f"[ptxas {name}] {ln}")

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references are true f32
    torch.backends.cudnn.allow_tf32 = False

    def attention_parity(label, qkv, a) -> float:
        out, v = aa.area_attention(qkv, *a)
        ref_out, ref_v = aa.area_attention_plain(qkv, *a)
        torch.cuda.synchronize()
        err = (out.float() - ref_out.float()).abs().max().item()
        tol = ATTN_TOL[str(qkv.dtype).split(".")[-1]]
        log(f"[attention] {label} {tuple(qkv.shape)} {qkv.dtype}: max_abs_err {err:.3e} "
            f"(tol {tol}), v exact {torch.equal(v, ref_v)}")
        check(err <= tol, f"attention {label} {qkv.dtype} off by {err}")
        check(torch.equal(v, ref_v), f"attention {label}: v passthrough differs")
        return err

    def nms_parity(label, boxes, valid, thr) -> int:
        keep = ns.nms_suppress(boxes, valid, thr)
        ref = ns.nms_suppress_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        bad = int((keep != ref).sum())
        log(f"[nms] {label} {tuple(boxes.shape)} iou {thr}: kept {int(keep.sum())} of "
            f"{int(valid.sum())} valid, mismatched bits {bad}")
        check(bad == 0, f"nms {label}: keep mask differs in {bad} places")
        return bad

    # 3. attention kernel vs its plain version: yolo11n's C2PSA shape (n=400
    # at imgsz 640), the ragged n=35 and n=1600 (imgsz 1280), f32 and bf16
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for n in (400, 35, 1600):
        for dt in (torch.bfloat16, torch.float32):
            qkv = torch.randn((32, n, 256), generator=gen, device=dev).to(dt)
            attention_parity(f"random n={n}", qkv, (2, 64, 32))

    # 4. NMS kernel vs its plain version: dense class-offset scenes
    rng = np.random.default_rng(args.seed)
    for thr in (0.45, 0.7):
        xy = rng.uniform(0, 600, (32, 1000, 2))
        wh = rng.uniform(8, 200, (32, 1000, 2))
        offset = rng.integers(0, 3, (32, 1000, 1)) * 7680.0
        boxes = torch.tensor(np.concatenate([xy, xy + wh], -1) + offset,
                             dtype=torch.float32, device=dev)
        nms_parity("random", boxes, torch.ones((32, 1000), dtype=torch.bool, device=dev), thr)

    # 5. predict, the main path (bf16)
    images = make_images(args.seed, 64)
    yolo = YOLO("yolo11n", nc=80, imgsz=640, seed=args.seed)
    check(yolo.dtype == torch.bfloat16, "predict on the card must default to bf16")
    zero_class_bias(yolo)
    recorded = {"attn": [], "nms": []}

    def rec_attention(qkv, *a):
        recorded["attn"].append((qkv.clone(), a))
        return orig_attention(qkv, *a)

    def rec_suppress(boxes, valid, thr):
        recorded["nms"].append((boxes.clone(), valid.clone(), thr))
        return orig_suppress(boxes, valid, thr)

    with patched(blocks, "area_attention", rec_attention) as orig_attention, \
            patched(nms_ops, "nms_suppress", rec_suppress) as orig_suppress:
        aa.launches = 0
        ns.launches = 0
        results = yolo.predict(images, conf=0.001, batch_size=32)
        torch.cuda.synchronize()
        launches = {"area_attention": aa.launches, "nms_suppress": ns.launches}
    log(f"[predict] {len(results)} images, launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(len(results) == len(images), "predict lost images")
    n_det = [len(d) for d in results]
    for d in results:
        check(np.isfinite(d.boxes).all() and np.isfinite(d.scores).all(), "non-finite output")
        check(d.boxes.shape == (len(d), 4), "bad box shape")
    check(min(n_det) > 0, "an image had no detections")
    log(f"[predict] n_det min {min(n_det)} mean {np.mean(n_det):.1f} max {max(n_det)}; "
        f"valid NMS candidates per image, min over each batch "
        f"{[int(v.sum(1).min()) for _, v, _ in recorded['nms']]} of "
        f"{[tuple(b.shape) for b, _, _ in recorded['nms']]}")
    # the kernels against their plain versions on the main path's own inputs
    attn_err_main = max(attention_parity(f"main-path call {i}", q, a)
                        for i, (q, a) in enumerate(recorded["attn"]))
    mismatched = sum(nms_parity(f"main-path call {i}", b, v, t)
                     for i, (b, v, t) in enumerate(recorded["nms"]))

    # f32 with TF32 off: the decoded (boxes, scores) before NMS, through the
    # attention kernel and through its plain version
    yolo32 = YOLO("yolo11n", nc=80, imgsz=640, seed=args.seed, dtype=torch.float32)
    zero_class_bias(yolo32)
    # the first 32 images letterboxed on the host: (32, 640, 640, 3) u8 on the card
    batch = torch.from_numpy(np.stack([letterbox_numpy(im, 640)[0] for im in images[:32]])).to(dev)
    fused32 = yolo32._fused_model()

    def decoded():
        with torch.no_grad():
            x = batch.permute(0, 3, 1, 2).to(torch.float32)
            return decode_predictions(*fused32(x), (640, 640))

    before = aa.launches
    kb, ks = decoded()
    check(aa.launches > before, "the f32 forward did not launch the attention kernel")
    with patched(blocks, "area_attention", aa.area_attention_plain):
        pb, ps = decoded()
    torch.cuda.synchronize()
    box_err = (kb - pb).abs().max().item()
    score_err = (ks - ps).abs().max().item()
    log(f"[predict f32] decoded boxes max_abs_err {box_err:.3e} px "
        f"(tol {PRED_TOL['boxes_px']}), scores {score_err:.3e} (tol {PRED_TOL['scores']})")
    check(torch.isfinite(kb).all().item() and torch.isfinite(ks).all().item(), "non-finite f32")
    check(box_err <= PRED_TOL["boxes_px"] and score_err <= PRED_TOL["scores"],
          "f32 decoded outputs differ between the kernel and plain paths")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, for the timings

    # 6. times
    kernels = []
    qkv, (heads, hd, kd) = recorded["attn"][0]
    ba, n, _ = qkv.shape
    ms = cuda_time_ms(lambda: aa.area_attention(qkv, heads, hd, kd), 200)
    plain_ms = cuda_time_ms(lambda: aa.area_attention_plain(qkv, heads, hd, kd), 50)
    split = qkv.view(ba, n, heads, 2 * kd + hd)
    q, k, v = (t.transpose(1, 2) for t in (split[..., :kd], split[..., kd:2 * kd],
                                           split[..., 2 * kd:]))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 200)
    nbytes = qkv.numel() * qkv.element_size() * (1 + 2 * heads * hd / qkv.shape[2])
    flops = 2.0 * ba * heads * n * n * (kd + hd)
    peak = BF16_FLOPS if qkv.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    kernels.append({
        "name": "area_attention", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/area_attention.cu",
        "replaces": "deal_yolo_daya_tpu/ops/pallas/area_attention.py:46",
        "launches": launches["area_attention"], "max_abs_err": attn_err_main,
        "tol": ATTN_TOL["bfloat16"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "shape": list(qkv.shape), "dtype": str(qkv.dtype),
    })
    log(f"[time] area_attention {tuple(qkv.shape)} {qkv.dtype}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"(bytes {t_bytes:.4f}, ops {t_ops:.4f})")

    boxes, valid, thr = recorded["nms"][0]
    ms = cuda_time_ms(lambda: ns.nms_suppress(boxes, valid, thr), 200)
    plain_ms = cuda_time_ms(lambda: ns.nms_suppress_plain(boxes, valid, thr), 10)
    nv = valid.sum(1).double()
    pairs = float((nv * (nv - 1) / 2).sum())
    nbytes = boxes.numel() * 4 + valid.numel() * 2  # boxes and valid in, keep out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, pairs * IOU_OPS / F32_FLOPS * 1e3
    kernels.append({
        "name": "nms_suppress", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "deal_yolo_daya_tpu/ops/pallas/nms_suppress.py:31",
        "launches": launches["nms_suppress"], "max_abs_err": float(mismatched),
        "tol": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": list(boxes.shape), "valid_pairs": pairs,
    })
    log(f"[time] nms_suppress {tuple(boxes.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.5f}, ops {t_ops:.4f}; "
        f"{pairs:.0f} valid pairs)")

    # the host letterbox alone, warm, median of 3 passes; each canvas is
    # dropped at once, as predict drops it after copying it into the batch
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        for im in images:
            letterbox_numpy(im, 640)
        host.append((time.perf_counter() - t0) * 1e3 / len(images))
    host_ms = sorted(host)[1]
    device_ms = cuda_time_ms(lambda: yolo.infer(batch, conf=0.001), 20)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        yolo.predict(images, conf=0.001, batch_size=32)
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    log(f"[time] predict b32 imgsz 640 bf16: {len(images) / wall:.1f} img/s end to end "
        f"({wall * 1e3:.1f} ms for {len(images)} images, median of 3); host letterbox "
        f"{host_ms:.2f} ms/img; device infer (forward+decode+NMS) {device_ms:.3f} ms/batch "
        f"= {32 / device_ms * 1e3:.1f} img/s")
    # 7. where the device time of the predict goes (torch.profiler)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yolo.predict(images, conf=0.001, batch_size=32)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in kernel_rows) / 1e3
    if kernel_rows:
        log(f"[profile] predict of {len(images)} images under the profiler: wall "
            f"{prof_wall_ms:.1f} ms, device busy {busy_ms:.2f} ms "
            f"({100 * busy_ms / prof_wall_ms:.1f}%, idle {100 - 100 * busy_ms / prof_wall_ms:.1f}%)")
        ours = [r for r in kernel_rows[15:] if "attention_" in r[2] or "nms_" in r[2]]
        for dev_us, count, key in kernel_rows[:15] + ours:
            log(f"[profile] {dev_us / 1e3:9.3f} ms {count:5d}x  {key[:100]}")
    else:
        log("[profile] the profiler recorded no device time")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "predict": {
        "imgs_per_s_e2e": len(images) / wall, "host_letterbox_ms_per_img": host_ms,
        "device_ms_per_b32": device_ms, "profiled_device_busy_ms": busy_ms,
        "profiled_wall_ms": prof_wall_ms, "card": card}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's yolo11n predict and train step on one NVIDIA card
and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card and nvcc. Phases:

1. environment: card name and power limit, torch and CUDA versions;
2. build: every kernel under ``deal_yolo_daya_tpu_torch/csrc`` is compiled
   (all nvcc processes at once) and ptxas' registers, shared memory and spills
   are printed;
3. attention kernels vs plain: yolo11n's C2PSA shape (32 x 400 tokens, 2
   heads, key_dim 32, head_dim 64) and the ragged 35 and 1600 tokens, in bf16
   and f32, at stated tolerances, the forward (``v`` exact) and the backward;
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
   kernels that take its time;
8. the train step, the second main path: ``TrainState`` for yolo11n, nc 80,
   imgsz 640, batch 32, bf16 autocast, random weights from ``--seed``, takes
   a few steps on numpy-made images with 2-8 boxes of 32-320 px each. The
   launch counts are set to 0 just before and read just after (each step
   must launch the attention forward and backward); every loss must be
   finite; both kernels are held against their plain versions on the inputs
   they got on that path;
9. f32 with TF32 off, batch 4: every parameter gradient of a train step
   through the kernels against the same step through the plain attention;
10. times: the backward kernel at the train path's inputs, its plain
   version, SDPA's backward alone, its bound; the train step's ms and img/s
   (CUDA events, warm, median);
11. profile: one train step under torch.profiler.

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

# attention forward, |kernel - plain| <= atol + rtol * |plain| elementwise:
# bf16 P is rounded unnormalised in the kernel, so an output may land a bf16
# step (2^-7 relative) from the plain version's
ATTN_TOL = {"bfloat16": (2e-2, 2 ** -7), "float32": (1e-4, 0.0)}
PRED_TOL = {"boxes_px": 1e-2, "scores": 1e-4}
# attention backward, |kernel - plain| <= atol * max |plain| + rtol * |plain|
# elementwise (cotangents have no fixed scale: on the train path they are
# ~1e-3): in bf16 both round P, dS and d_qkv to bf16 from f32 sums taken in
# other orders, so an element may land up to two bf16 steps (2^-7 relative)
# apart
BWD_TOL = {"bfloat16": (4e-3, 1.6e-2), "float32": (2e-5, 1e-4)}
# f32 train-step gradients through the kernels vs through the plain
# attention, per parameter: <= rtol * max |plain grad| + atol
GRAD_TOL = (1e-3, 1e-6)
TRAIN_STEPS = 4       # train steps on the main path
TIMED_STEPS = 10      # warm train steps under CUDA events


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


def make_train_batch(seed: int, batch: int, imgsz: int):
    """u8 (B, S, S, 3) images of smooth colour fields plus noise with 2-8
    boxes of 32-320 px each, painted in a colour of their class; GT padded to
    8 as (B, 8, 4) xyxy pixels, (B, 8) classes of 80, (B, 8) mask."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    cells = imgsz // 16
    base = rng.integers(0, 256, (batch, cells, cells, 3)).astype(np.int16)
    images = np.repeat(np.repeat(base, 16, 1), 16, 2)
    images = np.clip(images + rng.integers(-20, 21, images.shape), 0, 255).astype(np.uint8)
    palette = rng.integers(0, 256, (80, 3)).astype(np.uint8)
    boxes = np.zeros((batch, 8, 4), np.float32)
    classes = np.zeros((batch, 8), np.int64)
    mask = np.zeros((batch, 8), bool)
    for i in range(batch):
        for j in range(int(rng.integers(2, 9))):
            w, h = (int(v) for v in rng.integers(32, 321, 2))
            x, y = int(rng.integers(0, imgsz - w + 1)), int(rng.integers(0, imgsz - h + 1))
            c = int(rng.integers(0, 80))
            images[i, y:y + h, x:x + w] = palette[c]
            boxes[i, j], classes[i, j], mask[i, j] = (x, y, x + w, y + h), c, True
    return images, boxes, classes, mask


def small_gt_batch(images, seed: int):
    """GT of 8 boxes of 12-15 px per image, one in each of 8 distinct cells
    of a 4 x 4 grid: each GT has fewer candidate anchors than the assigner's
    top-k and no anchor lies in two GTs, so the assignment does not hang on
    near-ties of its bf16 metric."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    batch, imgsz = images.shape[0], images.shape[1]
    cell = imgsz // 4
    boxes = np.zeros((batch, 8, 4), np.float32)
    classes = rng.integers(0, 80, (batch, 8))
    for i in range(batch):
        for j, c in enumerate(rng.permutation(16)[:8]):
            w, h = (int(v) for v in rng.integers(12, 16, 2))
            x = cell * (c % 4) + int(rng.integers(2, cell - 2 - w))
            y = cell * (c // 4) + int(rng.integers(2, cell - 2 - h))
            images[i, y:y + h, x:x + w] = 255 - images[i, y:y + h, x:x + w]
            boxes[i, j] = (x, y, x + w, y + h)
    return images, boxes, classes, np.ones((batch, 8), bool)


def small_box_head(state_dict):
    """Box-head biases that favour DFL bin 1: random-init boxes ~2.5 grid
    units wide (20 px at stride 8), so that 12-15 px GTs get candidates."""
    import torch

    for i in range(3):
        bias = torch.zeros((4, 16))
        bias[:, 1] = 6.0
        state_dict[f"23.cv2.{i}.2.bias"] = bias.reshape(-1)
    return state_dict


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

    def within_tol(got, ref, atol, rtol):
        """(max |got - ref|, max of |got - ref| / (atol + rtol * |ref|))."""
        diff = (got.float() - ref.float()).abs()
        return diff.max().item(), (diff / (atol + rtol * ref.float().abs())).max().item()

    def attention_parity(label, qkv, a) -> float:
        out, v = aa.area_attention(qkv, *a)
        ref_out, ref_v = aa.area_attention_plain(qkv, *a)
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[str(qkv.dtype).split(".")[-1]]
        err, worst = within_tol(out, ref_out, atol, rtol)
        log(f"[attention] {label} {tuple(qkv.shape)} {qkv.dtype}: max_abs_err {err:.3e} "
            f"(|plain| max {ref_out.float().abs().max().item():.2f}), {worst:.3f} of the "
            f"tolerance atol {atol} + rtol {rtol} * |plain|, v exact {torch.equal(v, ref_v)}")
        check(worst <= 1.0, f"attention {label} {qkv.dtype} off by {err}")
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

    def backward_parity(label, qkv, d_out, d_v, a) -> float:
        got = aa.area_attention_bwd(qkv, d_out, d_v, *a)
        ref = aa.area_attention_bwd_plain(qkv, d_out, d_v, *a)
        torch.cuda.synchronize()
        atol, rtol = BWD_TOL[str(qkv.dtype).split(".")[-1]]
        scale = ref.float().abs().max().item()
        err, worst = within_tol(got, ref, atol * scale, rtol)
        log(f"[attention bwd] {label} {tuple(qkv.shape)} {qkv.dtype}: max_abs_err {err:.3e} "
            f"(|plain| max {scale:.3e}), {worst:.3f} of the tolerance "
            f"{atol} * max |plain| + {rtol} * |plain|")
        check(torch.isfinite(got).all().item(), f"attention bwd {label}: non-finite d_qkv")
        check(worst <= 1.0, f"attention bwd {label} {qkv.dtype} off by {err}")
        return err

    # 3b. attention backward kernel vs its plain version, the same shapes
    for n in (400, 35, 1600):
        for dt in (torch.bfloat16, torch.float32):
            qkv, d_out, d_v = (torch.randn((32, n, c), generator=gen, device=dev).to(dt)
                               for c in (256, 128, 128))
            backward_parity(f"random n={n}", qkv, d_out, d_v, (2, 64, 32))

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

    def profiled(label, run, ours, top):
        """Run ``run`` once under torch.profiler; log the device's busy share
        and its ``top`` kernels, plus any later one whose name holds a word
        of ``ours``. Returns (busy ms, wall ms)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = sorted(
            ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
            reverse=True)
        busy = sum(r[0] for r in rows) / 1e3
        if not rows:
            log("[profile] the profiler recorded no device time")
            return busy, wall
        log(f"[profile] {label} under the profiler: wall {wall:.1f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%)")
        later = [r for r in rows[top:] if any(w in r[2] for w in ours)]
        for dev_us, count, key in rows[:top] + later:
            log(f"[profile] {dev_us / 1e3:9.3f} ms {count:5d}x  {key[:100]}")
        return busy, wall

    busy_ms, prof_wall_ms = profiled(f"predict of {len(images)} images",
                                     lambda: yolo.predict(images, conf=0.001, batch_size=32),
                                     ("attention_", "nms_"), 15)

    # 8. train step, the second main path: yolo11n, nc 80, imgsz 640, batch
    # 32, bf16 autocast over f32 parameters, on numpy-made images and GT
    from deal_yolo_daya_tpu_torch.models.yolo11 import YOLO11, init_weights
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState, bucket_gt

    cfg = TrainConfig(model="yolo11n", imgsz=640, amp=True, seed=args.seed)
    state = TrainState(cfg, nc=80, steps_per_epoch=100, device=dev)
    imgs_np, boxes_np, cls_np, mask_np = make_train_batch(args.seed, 32, 640)
    train_x = torch.from_numpy(imgs_np).to(dev)
    train_gt = [torch.from_numpy(a).to(dev)
                for a in bucket_gt(boxes_np, cls_np, mask_np, cfg.max_boxes)]
    log(f"[train] batch {tuple(train_x.shape)} u8, GT per image {mask_np.sum(1).tolist()}, "
        f"GT tensors {[tuple(t.shape) for t in train_gt]}")
    train_rec = {"fwd": [], "bwd": []}

    def rec_fwd(qkv, *a):
        train_rec["fwd"].append((qkv.clone(), a))
        return orig_fwd(qkv, *a)

    def rec_bwd(qkv, d_out, d_v, *a):
        train_rec["bwd"].append((qkv.clone(), d_out.clone(), d_v.clone(), a))
        return orig_bwd(qkv, d_out, d_v, *a)

    totals, per_step = [], []
    with patched(aa, "area_attention_fwd", rec_fwd) as orig_fwd, \
            patched(aa, "area_attention_bwd", rec_bwd) as orig_bwd:
        aa.launches = 0
        aa.bwd_launches = 0
        for _ in range(TRAIN_STEPS):
            before = (aa.launches, aa.bwd_launches)
            totals.append(state.step(train_x, *train_gt))
            per_step.append((aa.launches - before[0], aa.bwd_launches - before[1]))
        torch.cuda.synchronize()
        train_launches = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches}
    losses = [t.item() for t in totals]
    parts = {k: v.item() for k, v in state.loss_acc.items()}
    for i, (loss, (nf, nb)) in enumerate(zip(losses, per_step)):
        log(f"[train] step {i}: loss {loss:.5f}, attention launches forward {nf} backward {nb}")
        check(nf >= 1 and nb >= 1, f"train step {i} did not launch both attention kernels")
    log(f"[train] loss parts summed over {TRAIN_STEPS} steps {parts}, launches {train_launches}")
    check(all(np.isfinite(losses)) and all(np.isfinite(list(parts.values()))), "non-finite loss")
    check(parts["num_fg"] > 0, "the assigner found no foreground")
    # the kernels against their plain versions on the train path's own inputs
    fwd_err_train = max(attention_parity(f"train-path call {i}", q, a)
                        for i, (q, a) in enumerate(train_rec["fwd"]))
    bwd_err_train = max(backward_parity(f"train-path call {i}", q, do, dv, a)
                        for i, (q, do, dv, a) in enumerate(train_rec["bwd"]))

    # 9. f32 with TF32 off, batch 4: every parameter gradient of one train
    # step through the kernels against the same step through the plain
    # attention, from the same weights
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = TrainConfig(model="yolo11n", imgsz=640, amp=False, seed=args.seed)
    weights = small_box_head(init_weights(YOLO11(nc=80, scale="n"), args.seed).state_dict())
    imgs4, *gt4 = small_gt_batch(imgs_np[:4].copy(), args.seed)
    x4, gt4 = torch.from_numpy(imgs4).to(dev), [torch.from_numpy(a).to(dev) for a in gt4]

    def f32_step():
        st = TrainState(cfg32, nc=80, steps_per_epoch=100, device=dev, state_dict=weights)
        before = aa.bwd_launches
        st.step(x4, *gt4)
        torch.cuda.synchronize()
        return ({n: p.grad for n, p in st.model.named_parameters()},
                {k: v.item() for k, v in st.loss_acc.items()}, aa.bwd_launches - before)

    grads_k, parts_k, launched_k = f32_step()
    with patched(blocks, "area_attention", aa.area_attention_plain):
        grads_p, parts_p, launched_p = f32_step()
    check(launched_k > 0 and launched_p == 0, "the f32 steps did not take the intended paths")
    rtol, atol = GRAD_TOL
    grad_worst = max(((g - grads_p[n]).abs().max().item()
                      / (rtol * grads_p[n].abs().max().item() + atol), n)
                     for n, g in grads_k.items())
    log(f"[train f32] loss parts kernel {parts_k} plain {parts_p}; worst gradient "
        f"{grad_worst[1]} at {grad_worst[0]:.3f} of the tolerance rtol {rtol} * max |grad| "
        f"+ atol {atol}, over {len(grads_k)} parameters")
    check(parts_k["num_fg"] == parts_p["num_fg"] > 0, "the f32 assignments differ")
    check(grad_worst[0] <= 1.0, f"f32 gradient of {grad_worst[1]} differs between the paths")
    torch.backends.cudnn.allow_tf32 = True

    # 10. times: the backward kernel at the train path's inputs, its plain
    # version, SDPA's backward alone, the bound; then the train step
    qkv_b, do_b, dv_b, (heads, hd, kd) = train_rec["bwd"][0]
    ba, n, _ = qkv_b.shape
    ms = cuda_time_ms(lambda: aa.area_attention_bwd(qkv_b, do_b, dv_b, heads, hd, kd), 200)
    plain_ms = cuda_time_ms(lambda: aa.area_attention_bwd_plain(qkv_b, do_b, dv_b, heads, hd, kd),
                            20)
    split = qkv_b.view(ba, n, heads, 2 * kd + hd)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in (split[..., :kd], split[..., kd:2 * kd], split[..., 2 * kd:]))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    sdpa_grad = do_b.view(ba, n, heads, hd).transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(
        lambda: torch.autograd.grad(sdpa_out, (q, k, v), sdpa_grad, retain_graph=True), 200)
    nbytes = (2 * qkv_b.numel() + do_b.numel() + dv_b.numel()) * qkv_b.element_size()
    flops = 2.0 * ba * heads * n * n * (3 * kd + 2 * hd)  # QK^T, dP, dV, dQ, dK
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    kernels[0]["launches_train"] = train_launches["area_attention"]
    kernels[0]["max_abs_err_train"] = fwd_err_train
    kernels.append({
        "name": "area_attention_bwd", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/area_attention_bwd.cu",
        "replaces": "deal_yolo_daya_tpu/ops/pallas/area_attention.py:69",
        "launches": train_launches["area_attention_bwd"], "max_abs_err": bwd_err_train,
        "tol": BWD_TOL["bfloat16"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "shape": list(qkv_b.shape), "dtype": str(qkv_b.dtype),
    })
    log(f"[time] area_attention_bwd {tuple(qkv_b.shape)} {qkv_b.dtype}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} for {nbytes / 1e6:.2f} MB, ops "
        f"{t_ops:.4f} for {flops / 1e9:.2f} GFLOP)")

    for _ in range(2):
        state.step(train_x, *train_gt)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TIMED_STEPS):
        state.step(train_x, *train_gt)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall_step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))[TIMED_STEPS // 2]
    log(f"[time] train step b32 imgsz 640 bf16: {step_ms:.2f} ms (median of {TIMED_STEPS}, CUDA "
        f"events) = {32 / step_ms * 1e3:.1f} img/s; host wall {wall_step_ms:.2f} ms/step; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 11. where the device time of one train step goes
    train_busy_ms, train_prof_wall_ms = profiled(
        "one train step", lambda: state.step(train_x, *train_gt), ("attention_", "bwd_"), 20)
    train_record = {
        "ms_per_step": step_ms, "imgs_per_s": 32 / step_ms * 1e3,
        "host_wall_ms_per_step": wall_step_ms, "losses": losses,
        "f32_grad_worst_of_tol": grad_worst[0], "profiled_device_busy_ms": train_busy_ms,
        "profiled_wall_ms": train_prof_wall_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "predict": {
        "imgs_per_s_e2e": len(images) / wall, "host_letterbox_ms_per_img": host_ms,
        "device_ms_per_b32": device_ms, "profiled_device_busy_ms": busy_ms,
        "profiled_wall_ms": prof_wall_ms, "card": card}, "train": train_record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

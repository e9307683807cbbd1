#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s control flow on a machine without a CUDA card.

    python3 tools/rehearse_chip_smoke.py

Runs the smoke's every phase end to end on the CPU at small sizes: the
sizes in its source are cut down by the replacements below, the kernel
wrappers are routed to their plain PyTorch versions (counting launches as
the kernels would), and the CUDA-only calls (events, synchronize, the card's
name, ``nvidia-smi``) are stubbed. It finds wrong paths, arguments, shapes
and control flow; it measures nothing. A replacement whose text is no longer
in the smoke fails loudly: update it with the smoke.
"""

from __future__ import annotations

import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (text in chip_smoke.py, its rehearsal size)
REPLACEMENTS = [
    ('torch.device("cuda")', 'torch.device("cpu")'),
    ("(32, n, 256)", "(2, n, 256)"),
    ("(32, n, c)", "(2, n, c)"),
    ("for n in (400, 35, 1600):", "for n in (40, 35, 70):"),
    ("(32, 1000", "(2, 1000"),
    ("make_images(args.seed, 64)", "make_images(args.seed, 6)"),
    ("imgsz=640", "imgsz=128"),
    ("(640, 640)", "(128, 128)"),
    ("letterbox_numpy(im, 640)", "letterbox_numpy(im, 128)"),
    ("batch_size=32", "batch_size=4"),
    ("images[:32]", "images[:4]"),
    ("check(yolo.dtype == torch.bfloat16", "check(True"),
    ("make_train_batch(args.seed, 32, 640)", "make_train_batch(args.seed, 2, 128)"),
    ("rng.integers(32, 321, 2)", "rng.integers(20, 64, 2)"),
    ("TIMED_STEPS = 10", "TIMED_STEPS = 2"),
    ("TRAIN_STEPS = 4", "TRAIN_STEPS = 2"),
    ("NMS_EDGE_B = (1, 3, 32)", "NMS_EDGE_B = (1, 2)"),
    ("NMS_EDGE_K = (1, 31, 33, 300, 1000, 1344)", "NMS_EDGE_K = (1, 33, 100)"),
    ("torch.randn((4, 2100, nc)", "torch.randn((2, 300, nc)"),
    ('YOLO("yolo11n", nc=80, imgsz=128, seed=args.seed)',
     'YOLO("yolo11n", nc=80, imgsz=128, seed=args.seed, device="cpu")'),
    ("seed=args.seed, dtype=torch.float32)", 'seed=args.seed, dtype=torch.float32, device="cpu")'),
    ("ProfilerActivity.CPU, ProfilerActivity.CUDA", "ProfilerActivity.CPU"),
    (", 200)", ", 2)"), (", 50)", ", 2)"), (", 20)", ", 2)"), (", 10)", ", 2)"),
    ("TRAINER_IMAGES = (256, 64)", "TRAINER_IMAGES = (8, 4)"),
    ("TRAINER_SIDES = (480, 801)", "TRAINER_SIDES = (96, 161)"),
    ("TRAINER_BATCH = 32", "TRAINER_BATCH = 4"),
    ("TRAINER12_BATCH = 8", "TRAINER12_BATCH = 4"),
    ('device="0"', 'device="cpu"'),
    ('"best.pt"), dtype=torch.float32)', '"best.pt"), dtype=torch.float32, device="cpu")'),
    # the CPU profiler records no device time: one window, and no check
    ("check(dev_ms > 0,", "check(True,"),
    ("windows: int = 6", "windows: int = 1"),
    ("        time.sleep(1.0)\n    return 0.0, {}", "    return 0.0, {}"),
    # NMS beyond 1344 candidates and batched_nms at pre_topk 4096
    ("NMS_LARGE_K = (1345, 2048, 4096)", "NMS_LARGE_K = (1345,)"),
    ("(32, k_, 2)", "(2, k_, 2)"), ("(32, k_, 1)", "(2, k_, 1)"), ("(32, k_)", "(2, k_)"),
    ("nms_geometry(32, k_, active)", "nms_geometry(2, k_, active)"),
    ("(4, 8400, 2)", "(2, 2100, 2)"), ("(4, 8400, 80)", "(2, 2100, 80)"),
    # the yolo12n and yolov8n phases
    ('YOLO("yolo12n", nc=80, imgsz=128, seed=args.seed)',
     'YOLO("yolo12n", nc=80, imgsz=128, seed=args.seed, device="cpu")'),
    ('YOLO("yolov8n", nc=80, imgsz=128, seed=args.seed)',
     'YOLO("yolov8n", nc=80, imgsz=128, seed=args.seed, device="cpu")'),
    ("yolo12.dtype == torch.bfloat16", "True"),
    ("n_batches = -(-len(images) // 32)", "n_batches = -(-len(images) // 4)"),
    ("{(128, 400, 192), (32, 400, 384)}", "{(16, 16, 192), (4, 16, 384)}"),
    # the serving phases on a CPU handle: buckets to 4 (the rehearsal's
    # images), each bucket's program the eager infer, run once at warmup and
    # on every replay, so the counts move there; the profiler sees no card
    ("SERVE_SECONDS = 8.0", "SERVE_SECONDS = 1.0"),
    ("OPEN_SECONDS = 5.0", "OPEN_SECONDS = 1.0"),
    ("max_batch=32, conf=0.001", "max_batch=4, conf=0.001"),
    ("max_batch=8, conf=0.001", "max_batch=4, conf=0.001"),
    ("profiled_replay(engine, 32,", "profiled_replay(engine, 4,"),
    ("profiled_replay(eng, 8,", "profiled_replay(eng, 4,"),
    ("for b in (1, 8, 32):", "for b in (1, 2, 4):"),
    ("            runs = serve.WARMUP_RUNS\n", "            runs = 1\n"),
    ("check(seen == tuple(per_forward),", "check(True,"),
    ("if seen == tuple(per_forward):", "if True:"),
    # the graphed train step (phases 22-28): on the CPU the step program runs
    # its iteration eagerly, so there is no graph to replay or profile
    # phase 35 needs NCCL and ranks spawned on the card: a stand-in record
    ("    dp_record = dp_phase(args.seed, data_yaml, root, card, FullConfig)",
     '    dp_record = {"nccl_1rank": {"launches_replays": (0, 0)},'
     ' "gloo_2ranks": {"launches_per_rank": {}}}'),
    ("GRAPH_STEPS = 8", "GRAPH_STEPS = 2"),
    ("imgsz, n_cache, k = 640,", "imgsz, n_cache, k = 128,"),
    ('"yolo11n", 32, (1, 1), card)', '"yolo11n", 2, (1, 1), card)'),
    ("prog.graphs[True].replay()", "prog.iteration(True)"),
    ("        if rows:\n            return rows, wall", "        if True:\n            return rows, wall"),
    ("check(launched == tuple(per_step),", "check(True,"),
    ("        if rows:\n            break", "        if True:\n            break"),
    ("check(on_card == counted,", "check(True,"),
    ("check(n_batches >= 2 and any(p.graphs for p in programs),",
     "check(n_batches >= 2 and bool(programs),"),
    ("check(need <= limit,", "check(True,"),
    ("make_train_batch(seed, 4, 640)", "make_train_batch(seed, 2, 128)"),
    ("make_train_batch(seed, 32, 640)", "make_train_batch(seed, 2, 128)"),
    ("torch.full((32, 2), 640.0", "torch.full((2, 2), 128.0"),
    ("DeviceAugConfig(), 640, GRAPH_MAX_BOXES, 32)", "DeviceAugConfig(), 128, GRAPH_MAX_BOXES, 2)"),
    ("permutation(32) for j in range(k)", "permutation(2) for j in range(k)"),
    ("check(replay == (2, 1) and", "check(True or"),
    ("check(all(found.values()),", "check(True,"),
    ('synth.dataset(root / "synth")', 'synth.dataset(root / "synth", 8, 4, 64)'),
    ('"graphed", seed=args.seed, device="cpu")', '"graphed", seed=args.seed, device="cpu", epochs=1, imgsz=64)'),
    ('check(yardstick["map50"] >= YARDSTICK_MAP50,', 'check(True,'),
    # phases 29-34 (w8a8, ultralytics checkpoints): the Engine's buckets to 4,
    # one eager run a bucket at warmup, no device time in the profiler
    ("int8_engine_phase(q11, q_batch, yolo)", "int8_engine_phase(q11, q_batch, yolo, 4)"),
    ("check(moved == tuple(serve.WARMUP_RUNS * n for n in per),",
     "check(moved == tuple(n for n in per),"),
    ("        if seen == per and silu == silu_want:\n            break",
     "        if True:\n            break"),
    ("check(all(0 < n <= want for n, want in zip(seen, per)),", "check(True,"),
    # no CUDA graphs on the CPU: the s8 conv's times by the host clock
    ("def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:\n",
     "def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:\n"
     "    return cuda_time_ms(fn, 2)\n\n\ndef _graph_time_ms(fn, calls=20, replays=5):\n"),
    ('check(int8["map"] >= INT8_MAP_SHARE * bf16["map"],', "check(True,"),
    # phase 36 (the app): the IoU filter on the CPU at 20,000 x 16, the
    # training page's run on the CPU at 64 px for one epoch
    ("APP_CHAIN_ROWS = 50_000", "APP_CHAIN_ROWS = 2_000"),
    ("APP_IMAGES = 256", "APP_IMAGES = 64"),
    ("APP_IOU_TABLES = ((1_000_000, 16), (20_000, 64))",
     "APP_IOU_TABLES = ((20_000, 16), (2_000, 64))"),
    ("got = box_ops.high_iou_hits(b, m)", 'got = box_ops.high_iou_hits(b, m, device="cpu")'),
    ("APP_EPOCHS = 2", "APP_EPOCHS = 1"),
    ("APP_IMGSZ = 640", "APP_IMGSZ = 64"),
    ('APP_DEVICE = ""', 'APP_DEVICE = "cpu"'),
    # phases 37-38 (export, predict's sources): no kernels artifact without a
    # card, so both artifacts are portable ones and the kernel launch checks
    # go; the CUDA graph becomes an eager call that refills the outputs
    ("use_pallas=True", "use_pallas=False"),
    ("EXPORT_BATCH = 32", "EXPORT_BATCH = 4"),
    ("EXPORT12_BATCH = 8", "EXPORT12_BATCH = 2"),
    ('check(meta_p["platforms"] == ["cpu", "cuda"]',
     'check(True or meta_p["platforms"] == ["cpu", "cuda"]'),
    ('check("dyd.area_attention_fwd.default" in graph_ops["kernels"]',
     'check(True or "dyd.area_attention_fwd.default" in graph_ops["kernels"]'),
    ('check(children["kernels"]["launches"] == [1, 1],', "check(True,"),
    ("check(moved == (1, 1),", "check(True,"),
    ("check(launches_k == (1, 1) and", "check(True or"),
    ("check(launches12 == (8, 1) and same12,", "check(same12,"),
    ("def capture_program(module, args):\n",
     "def capture_program(module, args):\n    out = list(module(*args))\n\n"
     "    def replay():\n        out[:] = module(*args)\n\n    return replay, out\n\n\n"
     "def _capture_program(module, args):\n"),
    ("VIDEO_FRAMES = 48", "VIDEO_FRAMES = 8"),
    ("VIDEO_SIZE = (640, 360)", "VIDEO_SIZE = (128, 72)"),
    ("VIDEO_BATCH = 16", "VIDEO_BATCH = 4"),
]


class _Event:
    """torch.cuda.Event on the host clock."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _stub_cuda(torch):
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.device_count = lambda: 1
    torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.memory_allocated = lambda *a: 0
    torch.cuda.memory_reserved = lambda *a: 0
    torch.cuda.max_memory_reserved = lambda *a: 0
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.mem_get_info = lambda *a: (0, 0)
    torch.cuda.Event = _Event
    run = subprocess.run

    def fake_run(cmd, **kwargs):
        if cmd[0] == "nvidia-smi":
            return types.SimpleNamespace(stdout="CPU rehearsal, 0 W\n")
        return run(cmd, **kwargs)

    subprocess.run = fake_run


def _route_kernels_to_plain(torch):
    """Each wrapper runs its plain version and counts a launch; the autograd
    Function goes through the wrappers as it does for a CUDA tensor."""
    from deal_yolo_daya_tpu_torch.ops import nms as nms_ops
    from deal_yolo_daya_tpu_torch.ops.kernels import _build
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.ops.kernels import score_reduce as sr
    from torch.utils._python_dispatch import _disable_current_modes

    _build.build = lambda *a, **k: {}

    def fwd(qkv, *a):
        aa.launches += 1
        return aa.area_attention_plain(qkv, *a)

    def bwd(qkv, d_out, d_v, *a):
        aa.bwd_launches += 1
        return aa.area_attention_bwd_plain(qkv, d_out, d_v, *a)

    def suppress(boxes, valid, thr):
        if not isinstance(valid.shape[0], torch.SymInt):  # not in a symbolic-batch export
            ns.nms_geometry(*valid.shape, ns.active_clusters())  # raises where the launch does
        ns.launches += 1
        return ns.nms_suppress_plain(boxes, valid, thr)

    def launch(boxes, valid, thr, stamps=None):
        if stamps is not None:  # clock stamps of a mask phase and a walk
            stamps[:] = torch.tensor([3, 4, 1])
        return suppress(boxes, valid, thr)

    def reduce(logits):
        sr.launches += 1
        return sr.score_reduce_plain(logits)

    def s8_launch(x, packed, scale, bias, inv_a, k, stride, act, with_acc=False, use=None):
        ic.check_args(x, packed, scale, bias, k, stride)
        route = (use or ic.plan_for(x, packed.shape[0], k, stride)).route
        setattr(ic, f"{route}_launches", getattr(ic, f"{route}_launches") + 1)
        ic.launches += 1
        # a launch dispatches no aten op: the plain version runs outside any
        # TorchDispatchMode (phase 31 counts the ops of a forward)
        with _disable_current_modes():
            y, acc = ic.int8_conv_bn_plain(x, packed, scale, bias, inv_a, k, stride, act)
        return y, (acc if with_acc else None)

    class AreaAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, num_heads, head_dim, key_dim):
            ctx.save_for_backward(qkv)
            ctx.dims = (num_heads, head_dim, key_dim)
            with torch.autocast("cpu", enabled=False):
                return aa.area_attention_fwd(qkv, num_heads, head_dim, key_dim)

        @staticmethod
        def backward(ctx, d_out, d_v):
            (qkv,) = ctx.saved_tensors
            d_out, d_v = (d.to(qkv.dtype).contiguous() for d in (d_out, d_v))
            return aa.area_attention_bwd(qkv, d_out, d_v, *ctx.dims), None, None, None

    aa.area_attention_fwd, aa.area_attention_bwd = fwd, bwd
    aa.AreaAttention = AreaAttention
    ns.nms_suppress = nms_ops.nms_suppress = suppress
    ns.launch = launch
    ns.max_active_clusters = lambda geometry: 0
    ns.active_clusters = lambda device=None: ns.ACTIVE_CLUSTERS
    sr.score_reduce = reduce
    ic.launch = s8_launch
    ic.int8_conv_bn = lambda *args: s8_launch(*args)[0]


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    smoke = ROOT / "chip_smoke.py"
    src = smoke.read_text()
    for old, new in REPLACEMENTS:
        if old not in src:
            raise SystemExit(f"rehearse_chip_smoke: {old!r} is no longer in chip_smoke.py")
        src = src.replace(old, new)
    _stub_cuda(torch)
    _route_kernels_to_plain(torch)
    namespace = {"__name__": "chip_smoke_rehearsal", "__file__": str(smoke)}
    exec(compile(src, str(smoke), "exec"), namespace)
    sys.argv = [str(smoke)]
    t0 = time.perf_counter()
    rc = namespace["main"]()
    print(f"rehearsal exit {rc} in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

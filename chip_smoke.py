#!/usr/bin/env python3
"""Drive the PyTorch port's yolo11n and yolo12n predict, train step (eager
and as a CUDA graph) and Trainer, yolov8n predict, the serving Engine of all
three, int8 (w8a8) predict, serving, bundles and validation, ultralytics
checkpoints in, data- and tensor-parallel training, the data pipeline and
the app's training call path, exported programs and predict's video and URL
sources, the run directory's plots and validation's native matcher, on one
NVIDIA card and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card and nvcc. Phases:

1. environment: card name and power limit, torch and CUDA versions;
2. build: every kernel under ``deal_yolo_daya_tpu_torch/csrc`` is compiled
   (all nvcc processes at once) and ptxas' registers, shared memory and spills
   are printed; every source must show 0 spill bytes;
3. attention kernels vs plain: yolo11n's C2PSA shape (32 x 400 tokens, 2
   heads, key_dim 32, head_dim 64) and the ragged 35 and 1600 tokens, in bf16
   and f32, at stated tolerances, the forward (``v`` exact) and the backward;
4. NMS kernel vs plain: dense class-offset scenes, B=32, K=1000, at iou 0.45
   and 0.7, and an edge grid (B 1, 3, 32 x K 1, 31, 33, 300, 1000, 1344 x
   iou 0, 0.45, 0.7, with holes in ``valid``); the keep masks must be
   bit-identical, and on the grid identical over two launches. The cluster
   geometry and ``cudaOccupancyMaxActiveClusters`` are printed. Beyond the
   cluster mapping's 1344 candidates, the global-memory mapping at K =
   1345, 2048 and 4096 (B=32, the same three iou), bit for bit against
   plain and twice; and ``batched_nms(pre_topk=4096)`` on (4, 8400) anchors
   of 80 classes on the card against the same call on the CPU, every output
   equal;
5. predict, the main path: ``YOLO("yolo11n", nc=80, imgsz=640)`` with random
   weights from ``--seed`` predicts 64 numpy-made images of mixed sizes at
   batch 32 and conf 0.001, in bf16. The launch counts are set to 0 just
   before and read just after; the kernels' inputs on that path are recorded
   and both kernels are held against their plain versions on them, and the
   attention forward against itself (two launches bit-identical). Then, in
   f32 with TF32 off, the decoded (boxes, scores) before NMS through the
   kernel against the same path through the plain attention;
6. times: each kernel at the main path's inputs, as its device time a call
   under torch.profiler and as the time a call costs with the host (CUDA
   events around 200 calls), its plain version, its bound from the shapes,
   the library call where one exists (both ways); predict's end-to-end img/s
   with the host letterbox and the device work apart;
7. profile: one predict under torch.profiler, the device's busy share and the
   kernels that take its time;
8. the train step, the second main path: ``TrainState`` for yolo11n, nc 80,
   imgsz 640, batch 32, bf16 autocast, random weights from ``--seed``, takes
   a few steps on numpy-made images with 2-8 boxes of 32-320 px each. The
   launch counts are set to 0 just before and read just after (each step
   must launch the attention forward and backward); every loss must be
   finite; both kernels are held against their plain versions on the inputs
   they got on that path, and against themselves (bit-identical twice);
9. f32 with TF32 off, batch 4: every parameter gradient of a train step
   through the kernels against the same step through the plain attention;
10. times: the backward kernel at the train path's inputs (device time and
   a call's time, as in 6), its plain version, SDPA's backward alone, its
   bound; the train step's ms and img/s (CUDA events, warm, median);
11. profile: one train step under torch.profiler;
12. the Trainer, the third main path: a shapes dataset (circles, squares,
   triangles; 256 train and 64 val PNG sources of 480-800 px on the long
   side, written with numpy and zlib into a temporary directory) trained by
   ``Trainer(TrainConfig(model="yolo11n", imgsz=640, batch=32, epochs=3,
   close_mosaic=1, cache="device", device_augment=True, amp=True))`` from
   random weights. The launch counts are set to 0 just before ``train()``
   and read just after: the attention forward once a train step and a
   validation batch, the backward once a train step, NMS once a validation
   batch. The NMS inputs of the validation batches are recorded and the
   kernel is held against its plain version on them. Checks: finite losses,
   results.csv's 3 rows of 15 columns,
   ``weights/last.pt`` reloading bit for bit, and ``YOLO(best.pt)`` detecting
   on a val batch what validation's EMA model detects (f32). Per epoch: wall,
   train img/s, augment and step ms (CUDA events), val ms a batch, host
   metric ms; the device cache's build time; one more epoch under
   torch.profiler;
13. score_reduce: the kernel on the class logits the predict and validation
   paths handed to decode (bf16, and an f32 copy), in every mapping (nc 1,
   8, 80, 81 in both dtypes, a view one element off a 16-byte boundary, an
   anchor-contiguous view), and on crafted rows (exact ties, rows of -inf
   or -3e38, 37 classes),
   against its plain version: classes and scores bit-identical. Against
   batched_nms' sigmoid-then-argmax on the same logits, every differing
   class must be a tie of f32 sigmoids. Times (as in 6): kernel, plain,
   torch.max with sigmoid, bound. No path calls the kernel: like the JAX package, NMS
   reduces sigmoid scores;
14. yolo12n predict: ``YOLO("yolo12n")``, the same 64 images at b32, 640,
   bf16, conf 0.001. The counts are set to 0 just before and read just
   after: 8 attention launches a batch (two ABlocks of two inner modules at
   ``b6``, area 4, and at ``b8``, area 1), all at (key_dim, head_dim) =
   (32, 32), and one NMS a batch. The (32, 32) forward is held to its plain
   version on every recorded call and to itself; img/s end to end, device
   ms a batch, a profile; the kernel's, its plain version's and SDPA's times
   at both call shapes, and the bound;
15. yolo12n train steps: b32, 640, bf16 autocast, the phase 8 batch; 8
   forward and 8 backward launches a step; both (32, 32) kernels held to
   their plain versions on the first step's calls and to themselves; every
   gradient of an f32 b4 step through the kernels against the plain
   attention; the backward's times at both shapes with SDPA's backward and
   forward plus backward; the step's ms; a profiled step;
16. the yolo12n Trainer: 3 epochs at b8 (96 steps, so that eval-mode
   BatchNorm's running statistics follow the data) on phase 12's shapes
   dataset. Launches: 8 forward a train step and a validation batch, 8
   backward a step, one NMS a validation batch. The checkpoint and
   args.yaml record the family, ``YOLO(best.pt)`` comes back as yolo12 and
   is held against validation's EMA model in f32 as in phase 12;
17. yolov8n predict: the same images; no attention launch, one NMS a batch,
   finite outputs and the head shapes (64 box bins and 80 classes at
   strides 8, 16, 32);
18. yolo11n serving: ``Engine(yolo, max_batch=32, conf=0.001, iou=0.7)`` on
   phase 5's handle. ``warmup()`` captures one CUDA graph a bucket (1-32),
   each capture and pool printed; the launch counts move by the eager
   warm-up runs and the capture and never on a replay. Each bucket's replay
   on phase 5's canvases equals the eager ``YOLO.infer`` bit for bit, and
   the attention and NMS kernels are held against their plain versions on
   the inputs that eager run gave them at that bucket (attention also on
   random qkv of those shapes); one profiled replay of bucket 32 shows the attention and NMS kernels once
   each, with their device times inside the graph. The futures equal
   ``predict`` bit for bit (32 in one burst at b32, 16 one at a time at
   ``max_batch=1``). Load windows on the 64 images letterboxed on 16 client
   threads, the counts at 0 before and after: closed loop at b32, open loop
   at half its rate, closed loop at ``max_batch=1``; img/s, p50/p95,
   avg_batch, pad_fraction, 0 errors. The host wall and device time of a
   replay against an eager ``infer`` at buckets 1, 8, 32;
19. HTTP: ``serve_http`` on a free port: /healthz, /stats, a PNG POST whose
   JSON equals the Engine's answer, a JPEG (200 with a decoder installed,
   else 415), an undecodable body (415), shutdown;
20. yolo12n and yolov8n serving at ``max_batch=8``: every bucket's replay
   bit-identical to eager, each bucket's kernels against their plain
   versions as in phase 18, a profiled replay with 8 + 1 and 0 + 1 launches;
21. ``export``/``from_export`` of phase 12's ``best.pt`` predicting bit for
   bit as its source, and ``YOLO(best.pt).val(data)`` against
   ``Trainer.validate`` on the same weights and config within 1e-6;
22. the train step as a CUDA graph (``train/step_graph.py``): yolo11n at b32
   and yolo12n at b8, 640, bf16, with a device cache of numpy-made images
   and the on-card augmentation: 8 steps from one state eagerly (twice,
   the noise floor) and through the step program (its eager warm-up
   steps, the capture, replays); parameters, EMA and BN statistics within
   GRAPH_TOL of the eager run's; the counters move at the warm-up and the
   capture and never on a replay; one replay under the profiler launches
   the attention forward and backward (1, 1) and (8, 8) times; the step's
   wall, host and device ms both ways, peak memory both ways;
23. the slice's main path: ``Trainer.train()`` for yolo11n on phase 12's
   dataset with the defaults (steps_per_dispatch auto: K = 8, the device
   cache, checkpoints in the background, validation each epoch), the counts
   at 0 before and read after (the warm-up steps and captures of the two
   programs, close_mosaic's the second, and the validation forwards), then
   the same with K = 1: per epoch train img/s, losses and mAP, the time a
   checkpoint holds the main thread, peak memory;
24. an epoch with ``device_augment=False``: the host augmentation's ms/img
   and the card's idle share under the profiler;
25. ``remat``: f32 b4 gradients against the plain step's (GRAD_TOL), 2 + 1
   attention launches a step, the peak memory of a b32 step with and
   without, and a graphed remat step with (2, 1) launches in a replay;
26. ``batch=-1``: the batch it picks and one step at it;
27. ``profile_steps=2``: the Chrome trace holds the attention kernels,
   the phase stamps and the program's spans;
28. the synth yardstick (``tools/train_synth_torch.py``): yolo11n, 30 epochs
   at 320 on 600 + 100 shapes images, the graphed step; mAP50 must reach
   YARDSTICK_MAP50;
29. int8 predict, this slice's main path: ``quantize_int8`` on phase 5's 64
   images (yolo11n, nc 80, 640, random weights from ``--seed``, class biases
   at 0), calibrated on the card; the int8 raw head outputs against the
   fused model's on a b32 batch at the JAX package's bar (INT8_HEAD_BAR, in
   f32; bf16 printed); predict at b32
   with the counts at 0 before and read after: the s8 ConvBN kernel once a
   quantized ConvBN (74: 69 on the tma route, 3 on the direct route, the
   stem's Cin 3 and one Cin 8 on the narrow route), attention and NMS once,
   a batch; img/s end
   to end and device ms a b32 batch, int8 and bf16 in turn; the weights'
   bytes both ways;
30. the fused s8 ConvBN (``csrc/int8_conv.cu``: conv, bias, SiLU) against
   its plain version, s32 sums bit for bit and outputs within S8_OUT_ULPS
   (0), and against itself (two launches), on every quantized ConvBN's
   input of phase 29's first batch and on edge shapes with and without act
   (Cin 3, K = 27; Cin 8; Cout 8, 67, 300; stride 2 at odd sizes; 1x1; B =
   1; M no multiple of the tile; Cin 48 at 3x3; a conv too wide for the
   wgmma kernel, on the narrow one; a base off the 16-byte alignment, on
   the direct route; a channel slice; bf16 and f32; inputs at +-127 steps, beyond,
   and on the k + 0.5 rounding ties); its times at the heaviest path conv
   with cuDNN's bf16 conv of the same shape and the bound, summed over a
   b32 batch by route, and ``torch._int_mm`` on the 1x1 convs as a
   yardstick;
31. the int8 Engine: buckets 1-32 captured, each replay bit-identical to
   the eager int8 ``infer``; no bias add or SiLU outside the s8 kernel,
   exactly: each ``Int8ConvBN`` forward dispatches no arithmetic op of its
   own, and the int8 forward as many adds as the bf16 one and as many SiLUs
   less as it has quantized ConvBNs with act (TorchDispatchMode); one
   profiled b32 replay with the s8 ConvBN, attention and NMS inside the
   graph; a b32 replay timed by CUDA events, int8 against bf16;
32. ``export``/``from_export`` of the int8 handle, predicting bit for bit as
   its source;
33. an ultralytics-layout fp16 ``best.pt`` of phase 12's weights
   (``tools/ultralytics_pt.py``, stand-in classes): ``from_ultralytics``
   predicts bit for bit as the fp16-rounded weights; ``Trainer(model=<.pt>)``
   fine-tunes an epoch under nc 4, its launches held to its steps and its
   report naming the class head;
34. the yardstick in int8: phase 28's model, ``val()`` in bf16, then
   ``quantize_int8`` on 64 of its train images and ``val(int8=True)``: int8
   mAP50-95 must reach INT8_MAP_SHARE of bf16's;
35. data parallelism on the one card (``parallel/``): a 1-rank NCCL group
   runs DP_GRAPH_STEPS yolo11n b32/640 bf16 steps through the distributed
   ``TrainState`` as a step program (the raw-batch all_gather, BatchNorm's
   moments, the loss normaliser and the gradient all-reduce captured in the
   graph), bit for bit as the same steps run eagerly in the group, with the
   attention forward and backward counted once each a replay; the graphed
   step's ms with the collectives against the one-card graph's; an f32 step
   (TF32 off) of the group against the one-card step at the data-parallel
   tests' bar (tests/test_torch_dp_step.py). Then two gloo ranks on the card
   (b16 each, spawned) take DP_STEPS bf16 steps from one state against one
   process on the b32 batch: loss sums and BN statistics within the
   DP_BF16 tolerances, each rank's attention launches 1 + 1 a step and its
   kernels held to their plain versions on its recorded inputs. Last, a
   1-epoch ``Trainer(device="1")`` on phase 12's data writes the same
   results.csv as ``device="0"``, and ``device="2"`` raises the JAX
   ValueError;
36. the app (the data pipeline and the Streamlit pages' call paths, with
   ``tools/synth_annotations_torch.py``): the pages' probes (no missing
   module, the device summary names the card) and the native label scanner
   built with g++ into ``_build/`` and loaded; steps 4-7 at 300 rows
   writing the bytes of ``tests/golden/datakit_chain_hashes.json``, and
   their wall at 50,000 rows; the nine steps through ``core.processor`` as
   the processing page calls them, on two raw CSVs (duplicate sources,
   corrupt JSON, null rows), a reference CSV and polygons on 256 local PNG
   sources of 240-1080 px, every row count as the inputs imply, step 8's
   datasets read back by ``train/data.py`` and step 9's drawings; the IoU
   filter on the card (1,000,000 x 16 and 20,000 x 64 packed boxes with
   planted ties at 0.98 in f32, pairs one f32 step either side, identical,
   zero-area and masked pairs) flag for flag against numpy, both timed;
   last the training page's call path, ``run_yolo_training_stream`` in a
   thread with the page's kwargs (yolo11n, 640, b16, 2 epochs, every
   visible card) on step 8's dataset, drained to ``LOG_DONE``: both epoch
   lines, no error, the run's files, and the attention and NMS launches
   that its steps and validation batches predict.
37. export (``export_stablehlo``/``load_stablehlo``, ``torch.export``
   programs): phase 5's yolo11n handle writes the portable artifact
   (symbolic batch, aten ops and the ``while_loop`` suppression) and the
   kernels artifact (b32, ``dyd::area_attention_fwd`` and
   ``dyd::nms_suppress`` as custom ops); each runs in a fresh process (the
   portable one importing nothing of either package) and equals the loaded
   artifact here; the kernels artifact equals ``ServeProgram`` run eagerly
   bit for bit and launches 1 + 1 kernels a b32 call, the portable one on
   the card equals the eager program with the plain attention and
   suppression bit for bit and launches none; conf x iou swept through one
   artifact, and one CUDA graph of it replayed at two iou values held in
   its input tensor, each equal to eager at its iou; b32 ms of both
   artifacts, the eager program and ``YOLO.infer``; yolo12n's kernels
   artifact at b8 (8 attention launches a call) bit for bit; the NMS
   kernel bit for bit with the threshold as a tensor in device memory at
   (32, 1000) and (32, 4096);
38. predict's sources: a 48-frame 640x360 mp4v video of phase 5's images
   streamed and saved at b16, every frame bit for bit as the same decoded
   frames as arrays, the ``_pred.mp4`` reopening with 48 frames,
   frames/s; an http URL from a local ``http.server`` (downloaded once,
   the second call a cache hit); ``runs/predict`` auto-incremented.
39. tensor parallelism on the one card (NCCL cannot hold two ranks of a group
   on one card: gloo ranks share it). Two ranks of a 1 x 2 mesh (data x
   model), spawned, each take TP_STEPS bf16 steps of yolo11n at 640 on the
   global b16 (``dp_steps``, the 11 convs of 256 channels and more sharded)
   against one process on the same batch: the sharded count equal to
   ``tp_param_shardings``', loss parts and BN statistics at phase 35's
   DP_BF16 bars, the gathered sharded weights within twice what one bf16 ulp
   of the stem kernel moves them plus DP_BF16_STATS_TOL of their move, the
   replicated parameters and BN statistics bit-identical on the two ranks,
   each rank's attention launches 1 + 1 a step and its kernels held to their
   plain versions on its recorded inputs. Then yolo11x (56 convs sharded) at
   640, b2, one f32 step with TF32 off in 1 x 2 against one process: the
   gradients at phase 35's f32 bar (per tensor within twice what a one-ulp
   nudge of the stem kernel moves the one-process step, plus the data-
   parallel tests' bar) and, as one vector, within TP_F32_GRAD_L2
   relative, the loss parts at DP_F32_LOSS_RTOL. Last a 1 x 2
   ``Trainer`` (``mesh=`` two places on the card) of yolo11n, 640, b16, one
   epoch of TP_TRAINER_STEPS steps on phase 12's data: rank 0's launches as
   phase 23 counts them, ``YOLO(best.pt)`` whole and equal in f32 to
   validation's EMA model (phase 12's check), the val_batch images written,
   and without matplotlib its seven files absent and one line naming them;
40. ``validate(save_artifacts=True)`` of a ``Trainer`` from phase 39's
   best.pt: the native matcher (``runtime/labelscan.cpp``, built with g++)
   taken on every image and equal to the numpy loop on the same inputs, the
   val_batch images written.
41. the phase stamps of the yolo11n b32/640 bf16 step graph
   (``ops/kernels/phase_stamp.py``): over STAMP_REPLAYS replays from
   counters set to 0, 6 stamp launches a replay, the ring's count advanced
   by one a replay and its rows in time order, ``phase_ms()`` summed within
   STAMP_SUM_TOL of the step's time by CUDA events, a ``train.stage`` and a
   ``train.replay`` span a step; again under the profiler, six stamp
   kernels a replay in slot order (but for at most STAMP_TRACE_LOST of
   them that the profiler drops), ``phase_ms()`` within STAMP_TRACE_TOL
   of the trace's phases, and no other program-named device activity.
42. the on-card augmentation's pixel kernel (``csrc/device_augment.cu``) at
   b32/640 on canvases of varied aspect: each ``apply``'s images against
   the plain PyTorch version (``pixels_plain``) on the plan that call
   handed the kernel, by configuration (the default; the mosaic gate off;
   mixup 0.5 on the whole batch and on two data-parallel ranks' rows; all
   flips and the BGR swap): one launch a call, images within AUG_LEVELS on
   at most AUG_SHARE of the values, a rank's boxes, classes, mask and
   images bit-equal to the whole batch's rows; ``apply`` as a CUDA graph,
   one launch a replay; the kernel's device time and a call's time, its
   plain version's, ``apply`` eager and replayed, the bound. Phases
   12, 16, 22, 23, 39 and 41 count its launches too: one a train step.
43. the attention kernels' (key_dim, head_dim) = (36, 72) builds (yolov10m's
   PSA, 4 heads on (32, 400, 576), copied by cp.async: the k columns are
   8-byte aligned only) against their plain versions in bf16 (ATTN_TOL and
   BWD_TOL, ``v`` exact) at the main shape and ragged token counts (37,
   401, 80) and in f32; one launch each way a call, 1 + 1 a replay of a
   CUDA graph of ``AreaAttention``'s forward and backward (its gradient
   held to plain); both kernels' device times, plain, SDPA and the bound.
44. the task-aligned assigner's kernels (``csrc/tal_assign.cu``) at the
   train cells' (32, 128, 8400, 80), top-k 10 and 1, against the plain
   version (``task_aligned_assign_plain``), every output bit for bit: on the
   inputs the yolo11n and yolov10m step programs' eager warm-up steps handed
   the assigner on each cell's own traffic, and on the CPU test's cases;
   one launch a call, 1 a replay of yolo11n's b32 step graph and 2 of
   yolov10m's; the kernel path's device time (at most TAL_MAX_MS), plain's
   and the bound.
45. train-mode BatchNorm + SiLU (``csrc/batch_norm_act.cu``) at every
   BatchNorm shape of the three train cells' b32/640 forwards, in bf16 and
   f32, against the plain version (``forward_plain``, ``backward_plain``):
   the output, the running statistics after one update, dx, d_weight and
   d_bias within BN_TOL; two launches a forward and two a backward; the
   masked route (C not a multiple of the vector) and a strided dz; a CUDA
   graph of forward and backward equal to the eager calls bit for bit;
   the three train cells' b32 step graphs on their own traffic: the
   Function's launches a replay (at most 4 a BatchNorm call), no ATen
   ``batch_norm`` kernel and no SiLU kernel but those of the ``F.silu``
   calls outside ConvBN; times of each cell's BatchNorm calls (CUDA events
   over graphs) beside their bound (8 S, S the outputs' bytes), the plain
   version and ATen's ``native_batch_norm`` + ``silu`` forward and backward.

Any failure raises and exits non-zero. On success the second-to-last line is
the JSON ``kernels`` record (with each kernel's profiler device time by
kernel name, NMS's split into its mask phase and walk by SM clock stamps and
its global-memory mapping's time at K = 4096, the (32, 32) attention builds
as rows of their own, each kernel's launches inside the serving graphs, and
the yolo12n and yolov8n records under ``families``, and each attention
kernel's ``train_graph_launches``, its launches inside one replay of the
graphed step; the s8 conv's row, then the phase stamp's with phase 41's
record under ``phases``, then the augmentation kernel's with phase 42's
under ``checks``, then the (36, 72) forward and backward rows of phase 43,
then the assigner's with phase 44's record under ``checks``, then BatchNorm + SiLU's with
phase 45's; phase 35's record under ``dp``,
phase 36's under ``app``, phase 39's under ``tp``, phase 40's under
``phase40``) and
the last line the device record; the ``serving``, ``train_graph`` and ``int8`` records, phases
37-38's ``export`` and ``sources`` records and the card's name come before them.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import csv
import dataclasses
import importlib.util
import json
import math
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
# YOLO(best.pt) (BN folded into the convs) against the yolo12n Trainer's
# validation model (unfused): the fold's f32 rounding goes through eight
# attention softmaxes over the still-large eval activations of a 96-step
# model, and decoded boxes moved 0.012 px on the card (yolo11n's 3-epoch
# model: 6e-5 px); 0.05 px is still 1/160 of the finest stride
PRED_TOL_YOLO12_BOXES_PX = 5e-2
# attention backward, |kernel - plain| <= atol * max |plain| + rtol * |plain|
# elementwise (cotangents have no fixed scale: on the train path they are
# ~1e-3): in bf16 both round P, dS and d_qkv to bf16 from f32 sums taken in
# other orders, so an element may land up to two bf16 steps (2^-7 relative)
# apart
BWD_TOL = {"bfloat16": (4e-3, 1.6e-2), "float32": (2e-5, 1e-4)}
# f32 train-step gradients through the kernels vs through the plain
# attention, per parameter: <= rtol * max |plain grad| + atol
GRAD_TOL = (1e-3, 1e-6)
NMS_EDGE_B = (1, 3, 32)                   # the NMS edge grid: images,
NMS_EDGE_K = (1, 31, 33, 300, 1000, 1344)  # candidates (1344: the cluster mapping's limit)
NMS_LARGE_K = (1345, 2048, 4096)          # the global-memory mapping, B=32
TRAIN_STEPS = 4       # train steps on the main path
TIMED_STEPS = 10      # warm train steps under CUDA events
# score_reduce vs its plain version: classes exact, and scores exact too (the
# kernel applies torch.sigmoid's CUDA formula, 1 / (1 + expf(-m)), to the same
# f32 max)
SCORE_TOL = 0.0
# the Trainer phase: a synthetic shapes dataset of mixed-size PNG sources
TRAINER_IMAGES = (256, 64)   # train, val
TRAINER_SIDES = (480, 801)   # long side of a source, px
TRAINER_BATCH = 32
TRAINER_EPOCHS = 3           # close_mosaic 1: mosaic in epochs 1-2, off in 3
# the yolo12n Trainer: 3 epochs of 32 steps at b8. Eval-mode BatchNorm needs
# ~60-100 steps before its running statistics follow the data: after one
# epoch at b32 (8 steps) validation's outputs grow ~3x a stage, to NaN in
# bf16, in the JAX Trainer as in the port
TRAINER12_BATCH = 8
# the serving phase's load windows: closed loop (at max_batch 32 and 1), and
# open loop at half the closed loop's rate
SERVE_SECONDS = 8.0
OPEN_SECONDS = 5.0
SHAPES = ["circle", "square", "triangle"]
# the graphed train step (phase 22): steps from one state both ways; GT
# padded to 32 boxes after the augmentation
GRAPH_STEPS = 8
GRAPH_MAX_BOXES = 32
# the phase stamps (phase 41): replays a window, more than the ring's 64
# rows, so that it wraps; the ring's phases summed against the step's time
# by CUDA events, and each against the trace's stamp intervals (5% or 20 us).
# Late in a long process the card's profiler drops a few activities (1-3
# of a window's 480 stamps after phases 1-40): the trace may lack this
# share of the stamps, each costing it at most one whole step
STAMP_REPLAYS = 80
STAMP_SUM_TOL = 0.02
STAMP_TRACE_TOL = (0.05, 0.02)
STAMP_TRACE_LOST = 0.05
# phase 42: the augmentation's pixel kernel against its plain PyTorch
# version (``pixels_plain``) on the plan each call handed it, at the
# benchmark's b32/640, canvases of varied aspect with AUG_BOXES boxes.
# Images: a value may be one level apart in at most AUG_SHARE of the values.
# The kernel repeats the plain version's f32 operations in their order, built
# with -fmad=false, but its HSV division and remainder may round apart from
# PyTorch's kernels in a last bit, and truncation to u8 turns that into one
# level. The boxes take no part in the route: a rank's are bit-equal to the
# whole batch's rows
AUG_BATCH = 32
AUG_IMGSZ = 640
AUG_BOXES = 16
AUG_MAX_BOXES = 64
AUG_LEVELS = 1
AUG_SHARE = 1e-4
AUG_REPLAYS = 20
AUG_CASES = (("default", {}, 1), ("mosaic gate off", {"mosaic": 0.0}, 1),
             ("mixup 0.5", {"mixup": 0.5}, 1), ("mixup 0.5, 2 ranks", {"mixup": 0.5}, 2),
             ("flips and bgr", {"fliplr": 1.0, "flipud": 1.0, "bgr": 1.0}, 1))
# graphed vs eager after GRAPH_STEPS steps: |diff| <= GRAPH_TOL x the largest
# move of its kind (parameters, EMA, BN statistics) from the start. The
# replay runs the eager step's kernels in its order, and came out bit for
# bit equal on an H100; the tolerance leaves room for a cuDNN algorithm
# that accumulates in another order
GRAPH_TOL = 1e-4
# phase 35: eager steps of the two gloo ranks; steps_per_dispatch of the
# 1-rank NCCL group; replays timed a round (three rounds each way)
DP_STEPS = 4
DP_GRAPH_STEPS = 8
DP_TIMED_REPLAYS = 10
# the f32 step of the 1-rank group against the one-card step (TF32 off):
# loss parts at the data-parallel tests' 1e-5 (tests/test_torch_dp_step.py);
# gradients and state per tensor within twice what a one-ulp change of the
# stem kernel moves the one-card step, plus that bar: in f32 the step's own
# sensitivity is above the bar (on an H100 the one-ulp change alone moved 59
# of 255 gradient tensors outside it), which the tests meet in float64
DP_F32_LOSS_RTOL = 1e-5
DP_F32_GRAD_TOL = (1e-4, 1e-5)   # rtol, atol
DP_F32_STATE_ATOL = 1e-6
# ... and the state (parameters, BN running statistics up to ~20, where one
# f32 ulp is 2e-6) also within two ulps of each tensor's largest value
DP_F32_STATE_ULPS = 2
# two gloo ranks (b16 each) against one process (b32), 4 bf16 steps: cuDNN
# picks its algorithms for b16 and b32 apart and the two halves' BatchNorm
# moments combine in another order, each a bf16 rounding (2^-8) apart in the
# activations; over 4 steps that moves the loss sums by up to a few bf16
# steps and the running statistics by a few bf16 steps of their move
DP_BF16_LOSS_RTOL = 2e-2
DP_BF16_STATS_TOL = 5e-2
# phase 39: tensor parallelism on the one card, a 1 x 2 mesh of gloo ranks:
# TP_STEPS bf16 steps of yolo11n at TP_BATCH against one process (loss parts
# and BN statistics at the DP_BF16 bars; the gathered sharded weights within
# twice what one bf16 ulp of the stem kernel moves them in the one-process
# run, plus DP_BF16_STATS_TOL of their move); one f32 step of
# yolo11x at TP_X_BATCH: per tensor at phase 35's f32 bar (within twice
# what a one-ulp change of the stem kernel moves the one-process step, plus
# DP_F32_GRAD_TOL), and all its gradients as one vector within
# TP_F32_GRAD_L2 of the one-process step's, relative to its norm (set between
# the readings of an H100: 1 x 2 gave 2.87e-6, the one-process step with the
# stem kernel moved by one ulp 1.14e-3); a 1 x 2 Trainer epoch of
# TP_TRAINER_STEPS steps on phase 12's data
TP_MIN_CHANNELS = 256        # the JAX Trainer's tp_param_shardings threshold
TP_BATCH = 16
TP_STEPS = 4
TP_X_BATCH = 2
TP_F32_GRAD_L2 = 1e-4
TP_TRAINER_STEPS = 4
AUTOBATCH_REPEATS = 8        # phase 26: 8 x 256 train images, two batches at the cap of 1024
# phase 36: steps 4-7 timed on APP_CHAIN_ROWS synthetic rows; the nine steps
# on APP_IMAGES local PNG sources; the IoU filter's packed tables (rows,
# boxes a row; 64 is step 5's cap); the training page's run
APP_CHAIN_ROWS = 50_000
APP_IMAGES = 256
APP_IOU_TABLES = ((1_000_000, 16), (20_000, 64))
APP_EPOCHS = 2
APP_IMGSZ = 640
APP_BATCH = 16
APP_DEVICE = ""              # the page's default: every visible card, here one
APP_LINE_TIMEOUT_S = 600
# w8a8 (phases 29-34): the H100's dense int8 tensor-core peak (NVIDIA data
# sheet), operations/s
INT8_OPS = 1979e12
# the int8 raw head outputs against the bf16 fused model's at each level: the
# JAX package's own bar (tests/test_quant.py:44-53), correlation above and
# mean relative difference below
INT8_HEAD_BAR = (0.98, 0.1)
# the int8 yardstick: mAP50-95 in int8 at least this share of bf16's (the JAX
# package measured -0.8% on its own yardstick)
INT8_MAP_SHARE = 0.98
# the fused s8 ConvBN's output against its plain version: the kernel rounds
# each step as PyTorch does (IEEE division, the accurate expf), so 0 ulps;
# any element that differs is counted and printed
S8_OUT_ULPS = 0
# the s8 ConvBN's routes (ops/kernels/int8_conv.py::plan), each with its count
S8_ROUTES = ("tma", "direct", "narrow")
# the synth yardstick (phase 28): a floor that catches a broken step; the
# JAX package reached 0.988 on its own data
YARDSTICK_MAP50 = 0.90
# phase 37: the exported programs' batches, the thresholds swept through one
# artifact; phase 38: the video predict reads
EXPORT_BATCH = 32
EXPORT12_BATCH = 8
EXPORT_CONFS = (0.001, 0.25, 0.9)
EXPORT_IOUS = (0.45, 0.7)
VIDEO_FRAMES = 48
VIDEO_SIZE = (640, 360)
VIDEO_FPS = 24.0
VIDEO_BATCH = 16


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


def within_tol(got, ref, atol, rtol):
    """(max |got - ref|, max of |got - ref| / (atol + rtol * |ref|))."""
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff / (atol + rtol * ref.float().abs())).max().item()


def attention_parity(label, qkv, a) -> float:
    """The attention forward kernel against its plain version on one call's
    inputs (ATTN_TOL; ``v`` exact) -> max |kernel - plain|."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa

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


def backward_parity(label, qkv, d_out, d_v, a) -> float:
    """The attention backward kernel against its plain version on one call's
    inputs (BWD_TOL) -> max |kernel - plain|."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa

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


def device_time_ms(fn, calls: int = 50, windows: int = 6):
    """Mean device time a call of ``fn`` under torch.profiler, from a window
    of ``calls`` warm calls: for every device activity, its mean self device
    time a launch times its launches a call (its count over ``calls``,
    rounded). -> (ms, {kernel name: its ms a call}); (0.0, {}) when no window
    was whole. A window is whole when the profiler recorded device time and
    every activity at most a tenth short of a whole number of launches a
    call (on the card it misses a few short launches at a window's edge,
    and it has dropped a window's events, whole or in part, and three
    windows in a row once); up to ``windows`` windows are taken, a second
    apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        per_call = {k: us / n * round(n / calls) / 1e3 for k, us, n in rows}
        if rows and all(round(n / calls) >= 1 and n >= 0.9 * calls * round(n / calls)
                        for _, _, n in rows):
            return sum(per_call.values()), per_call
        log(f"[profile] a window of {calls} calls came back with device activities counted "
            f"{[n for _, _, n in rows]} times; taking another")
        time.sleep(1.0)
    return 0.0, {}


def call_and_device_ms(fn, what: str):
    """The time a call of ``fn`` costs its caller, host included (CUDA events
    around 200 calls in a row), and its device time (``device_time_ms``)
    -> (call ms, device ms, text for the log, {kernel name: its device ms}).
    Fails when no profiler window was whole."""
    call_ms = cuda_time_ms(fn, 200)
    dev_ms, per_kernel = device_time_ms(fn)
    check(dev_ms > 0, f"no whole profiler window with device time for {what}")
    parts = "; ".join(f"{k[:70]} {v:.4f}" for k, v in sorted(per_kernel.items()))
    return call_ms, dev_ms, (f"device {dev_ms:.4f} ms ({parts}), a call {call_ms:.4f} ms with "
                             "the host"), {k[:90]: v for k, v in per_kernel.items()}


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
        for branch in yolo._ensure_built().head().cv3:
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


def small_box_head(state_dict, detect: int = 23):
    """Box-head biases (of the detect module ``detect``) that favour DFL bin
    1: random-init boxes ~2.5 grid units wide (20 px at stride 8), so that
    12-15 px GTs get candidates."""
    import torch

    for i in range(3):
        bias = torch.zeros((4, 16))
        bias[:, 1] = 6.0
        state_dict[f"{detect}.cv2.{i}.2.bias"] = bias.reshape(-1)
    return state_dict


def shapes_sample(seed: int, split: str, i: int):
    """One source of the shapes dataset (tools/synth_dataset.py's content,
    drawn with numpy): a noisy background of random size, 480-800 px on the
    long side, with 1-4 circles, squares and triangles -> (RGB u8 image,
    label lines)."""
    import numpy as np

    rng = np.random.default_rng((seed, len(split), i))
    lo, hi = TRAINER_SIDES
    long = int(rng.integers(lo, hi))
    short = int(long * rng.uniform(0.6, 1.0))
    h, w = (long, short) if rng.random() < 0.5 else (short, long)
    img = rng.integers(30, 120, 3) + rng.normal(0, 18, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    colours = [(220, 60, 60), (60, 200, 80), (70, 90, 230)]
    lines, placed = [], []
    for _ in range(int(rng.integers(1, 5))):
        c = int(rng.integers(0, 3))
        r = int(rng.integers(min(h, w) // 14, min(h, w) // 5))
        cx, cy = int(rng.integers(r + 2, w - r - 2)), int(rng.integers(r + 2, h - r - 2))
        if any(max(0, min(cx + r, x2) - max(cx - r, x1)) * max(0, min(cy + r, y2) - max(cy - r, y1))
               >= 0.3 * (2 * r) ** 2 for x1, y1, x2, y2 in placed):
            continue
        yy, xx = np.mgrid[cy - r:cy + r + 1, cx - r:cx + r + 1]
        if c == 0:
            inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        elif c == 1:
            inside = np.ones_like(xx, bool)
        else:  # apex at the top, base at the bottom
            inside = 2 * np.abs(xx - cx) <= yy - (cy - r)
        colour = np.clip(np.array(colours[c]) + rng.integers(-25, 25, 3), 0, 255)
        img[cy - r:cy + r + 1, cx - r:cx + r + 1][inside] = colour
        placed.append((cx - r, cy - r, cx + r, cy + r))
        lines.append(f"{c} {cx / w:.6f} {cy / h:.6f} {2 * r / w:.6f} {2 * r / h:.6f}")
    return img, lines


def write_shapes_dataset(root: Path, seed: int) -> Path:
    """TRAINER_IMAGES sources in the YOLO layout, as PNG through zlib, with a
    data.yaml of the three classes."""
    import concurrent.futures as cf

    import yaml

    from deal_yolo_daya_tpu_torch.ops.png import write_png

    def one(job):
        split, i = job
        img, lines = shapes_sample(seed, split, i)
        write_png(root / "images" / split / f"{i:05d}.png", img)
        (root / "labels" / split / f"{i:05d}.txt").write_text("\n".join(lines))

    jobs = []
    for split, n in zip(("train", "val"), TRAINER_IMAGES):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        jobs += [(split, i) for i in range(n)]
    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))
    data_yaml = root / "data.yaml"
    data_yaml.write_text(yaml.safe_dump({"path": str(root), "train": "images/train",
                                         "val": "images/val", "nc": 3, "names": SHAPES},
                                        sort_keys=False))
    return data_yaml


def widest_gap(values, lo: float, hi: float):
    """The middle of the widest gap between consecutive values in [lo, hi]:
    a value that moves by less than half the gap cannot cross it.
    -> (threshold, gap)"""
    import torch

    v = torch.sort(values[(values >= lo) & (values <= hi)].flatten()).values
    v = torch.cat([v.new_tensor([lo]), v, v.new_tensor([hi])])
    gaps = v[1:] - v[:-1]
    i = int(gaps.argmax())
    return float((v[i] + v[i + 1]) / 2), float(gaps[i])


def nms_thresholds(boxes, scores, lo_rank: int, hi_rank: int):
    """Thresholds at which class-agnostic greedy NMS does not hang on f32
    noise: conf in the widest gap between the best-class scores of ranks
    lo_rank..hi_rank, and iou in the widest gap between the candidates' IoUs
    in [0.6, 0.8]. -> (conf, conf gap, iou, iou gap)"""
    import torch

    from deal_yolo_daya_tpu_torch.ops.boxes import box_iou_matrix

    best = scores.amax(-1)
    top = torch.sort(best.flatten(), descending=True).values
    conf, conf_gap = widest_gap(top[lo_rank:hi_rank + 1], float(top[hi_rank]), float(top[lo_rank]))
    ious = []
    for b, s in zip(boxes, best):
        keep = s > conf
        ious.append(box_iou_matrix(b[keep], b[keep]).triu(1).flatten())
    iou, iou_gap = widest_gap(torch.cat(ious), 0.6, 0.8)
    return conf, conf_gap, iou, iou_gap


def nms_order_flips(boxes, scores, other_scores, conf: float, iou: float):
    """Per image, whether two candidates that overlap beyond iou come in one
    order by ``scores`` and in the other by ``other_scores``: greedy NMS
    keeps whichever comes first, so the two may keep different boxes."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.boxes import box_iou_matrix

    flags = []
    for b, s, o in zip(boxes, scores.amax(-1), other_scores.amax(-1)):
        keep = s > conf
        sk, ok = s[keep], o[keep]
        flip = torch.sign(sk[:, None] - sk[None, :]) != torch.sign(ok[:, None] - ok[None, :])
        flags.append(bool((flip & (box_iou_matrix(b[keep], b[keep]) > iou)).triu(1).any()))
    return flags


# ---------------------------------------------------------------- phases 22-28


def profile_rows(run):
    """Run ``run`` once under torch.profiler -> ([(kernel name, launches,
    device ms)], wall ms); the card's profiler has dropped whole windows, so
    an empty one is taken again (up to three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if rows:
            return rows, wall
        log("[profile] the profiler recorded no device time; taking another window")
        time.sleep(1.0)
    raise RuntimeError("three profiler windows in a row recorded no device time")


def attention_launches(rows):
    """(forward, backward) attention launches among profiler rows: the
    backward wrapper launches its query-row and key-row passes once each."""
    fwd = sum(n for k, n, _ in rows if "attention_bf16_kernel" in k or "attention_f32_kernel" in k)
    bwd = sum(n for k, n, _ in rows if "bwd_query_rows" in k)
    return fwd, bwd


def state_diffs(a, b, start):
    """The largest |a - b| over the parameters, the EMA and the BN running
    statistics of two TrainStates, each beside the largest move of its kind
    from ``start`` (a ``state()`` of the shared start)."""
    va, vb = a.state_views(), b.state_views()
    names = [n for n, _ in a.model.named_parameters()]
    stats = [k for k in va["model"] if "running_" in k]
    out = {}
    for kind, part, keys in (("params", "model", names), ("ema", "ema", names),
                             ("bn_stats", "model", stats)):
        diff = max((va[part][k] - vb[part][k]).abs().max().item() for k in keys)
        move = max((vb[part][k].cpu() - start[part][k]).abs().max().item() for k in keys)
        out[kind] = {"max_abs_diff": diff, "max_move": move}
    return out


def graph_vs_eager(seed: int, model: str, batch: int, per_step: tuple, card: str):
    """Phase 22: GRAPH_STEPS train steps of ``model`` at ``batch``, 640,
    bf16, from one state, eagerly (twice: the noise floor) and through the
    step program (WARMUP_RUNS eager steps, the capture, replays), on a
    device cache of numpy-made images with the on-card augmentation; their
    parameters, EMA and BN statistics against each other; the kernels'
    launches inside one replay by the profiler; the step's wall, host and
    device ms both ways; peak memory both ways."""
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.device_augment import (DeviceAugConfig, augment_batch,
                                                                step_seed)
    from deal_yolo_daya_tpu_torch.train.step_graph import StepProgram

    dev = torch.device("cuda")
    imgsz, n_cache, k = 640, 2 * batch, GRAPH_STEPS
    images, boxes, classes, mask = make_train_batch(seed + 7, n_cache, imgsz)
    cache = tuple(torch.from_numpy(a).to(dev) for a in (
        images, np.full((n_cache, 2), imgsz, np.float32), boxes, classes.astype(np.int32), mask))
    rng = np.random.default_rng(seed + 9)
    idx = np.stack([rng.permutation(n_cache)[:batch] for _ in range(k)])
    seeds = [step_seed(seed, 0, j) for j in range(k)]
    aug = DeviceAugConfig()
    cfg = TrainConfig(model=model, imgsz=imgsz, amp=True, seed=seed, max_boxes=GRAPH_MAX_BOXES)
    fresh = lambda: TrainState(cfg, nc=80, steps_per_epoch=100, device=dev)  # noqa: E731
    start = fresh().state()

    def eager(st):
        for j in range(k):
            t = torch.from_numpy(idx[j]).to(dev)
            st.step(*augment_batch(*(c[t] for c in cache), seeds[j], imgsz, aug, GRAPH_MAX_BOXES))

    def timed(fn):
        """-> (wall, host, events) ms a step: the host clock to the end of
        a synchronise, the host clock to the return (the enqueue), CUDA
        events around the call."""
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall * 1e3 / k, host * 1e3 / k, e0.elapsed_time(e1) / k

    # peak memory above what was allocated before (the state included)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    e1 = fresh()
    eager(e1)
    torch.cuda.synchronize()
    peak_eager = (torch.cuda.max_memory_allocated() - base) / 1e9
    e2 = fresh()
    eager(e2)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = fresh()
    prog = StepProgram(g, cache, aug, imgsz, GRAPH_MAX_BOXES, batch)
    aa.launches = aa.bwd_launches = dk.launches = 0
    prog.run(idx, seeds)
    torch.cuda.synchronize()
    first_counts = (aa.launches, aa.bwd_launches)
    first_aug = dk.launches
    peak_graph = (torch.cuda.max_memory_allocated() - base) / 1e9
    noise = state_diffs(e1, e2, start)
    diffs = state_diffs(g, e1, start)
    for kind in diffs:
        log(f"[graph {model}] after {k} steps, {kind}: graphed vs eager max |diff| "
            f"{diffs[kind]['max_abs_diff']:.3e}, eager vs eager {noise[kind]['max_abs_diff']:.3e}, "
            f"largest move from the start {diffs[kind]['max_move']:.3e}")
    worst = max(d["max_abs_diff"] / (GRAPH_TOL * d["max_move"]) for d in diffs.values())
    log(f"[graph {model}] worst difference {worst:.3f} of the tolerance ({GRAPH_TOL} of the "
        f"largest move of its kind); loss sums graphed "
        f"{ {n: round(v.item(), 6) for n, v in g.loss_acc.items()} } eager "
        f"{ {n: round(v.item(), 6) for n, v in e1.loss_acc.items()} }")
    check(worst <= 1.0, f"{model}: the graphed steps left the eager steps' state")
    # WARMUP_RUNS eager steps, the capture (which launches nothing) and
    # k - WARMUP_RUNS replays: each step's launches counted once
    want = tuple(k * n for n in per_step)
    check(first_counts == want, f"{model}: the counters moved by {first_counts} over the "
          f"warm-up, the capture and the replays, not {want}")
    check(first_aug == k, f"{model}: {first_aug} augmentation kernel launches in {k} steps")

    # the steps' times, then one replay and one eager step under the profiler
    aa.launches = aa.bwd_launches = dk.launches = 0
    g_wall, g_host, g_events = timed(lambda: prog.run(idx, seeds))
    check((aa.launches, aa.bwd_launches) == want,
          f"{model}: {k} replays counted {(aa.launches, aa.bwd_launches)}, not {want}")
    check(dk.launches == k, f"{model}: {dk.launches} augmentation kernel launches in {k} replays")
    e_wall, e_host, e_events = timed(lambda: eager(e2))
    rows, replay_wall = profile_rows(lambda: prog.graphs[True].replay())
    launched = attention_launches(rows)
    check(launched == tuple(per_step), f"{model}: one replay launched (forward, backward) "
          f"attention {launched}, not {per_step}")
    replay_busy = sum(r[2] for r in rows)
    t = torch.from_numpy(idx[0]).to(dev)
    eager_rows, eager_wall = profile_rows(lambda: e2.step(*augment_batch(
        *(c[t] for c in cache), seeds[0], imgsz, aug, GRAPH_MAX_BOXES)))
    eager_busy = sum(r[2] for r in eager_rows)
    kernel_ms = {k_[:60]: round(ms / n, 4) for k_, n, ms in rows
                 if "attention_" in k_ or "bwd_" in k_}
    log(f"[graph {model}] b{batch}: graphed step wall {g_wall:.2f} ms, host {g_host:.2f} ms, "
        f"CUDA events {g_events:.2f} ms; one replay busy {replay_busy:.2f} ms of "
        f"{replay_wall:.2f} ms under the profiler; eager step wall {e_wall:.2f} ms, host "
        f"{e_host:.2f} ms, CUDA events {e_events:.2f} ms, busy {eager_busy:.2f} ms of "
        f"{eager_wall:.2f} ms; kernels in the replay (forward, backward) {launched}, device ms "
        f"a launch {kernel_ms}; capture {prog.capture_s:.2f} s; peak memory (state, steps "
        f"and graph pool) graphed {peak_graph:.2f} GB, eager {peak_eager:.2f} GB ({card})")
    return {"batch": batch, "steps": k, "diffs": diffs, "eager_noise": noise,
            "worst_of_tol": worst, "replay_launches": dict(zip(("forward", "backward"), launched)),
            "replay_kernel_ms": kernel_ms, "counts_over_first_dispatch": first_counts,
            "augment_launches_first_dispatch": first_aug,
            "graphed": {"wall_ms": g_wall, "host_ms": g_host, "events_ms": g_events,
                        "busy_ms": replay_busy, "peak_gb": peak_graph, "capture_s": prog.capture_s},
            "eager": {"wall_ms": e_wall, "host_ms": e_host, "events_ms": e_events,
                      "busy_ms": eager_busy, "peak_gb": peak_eager}}


def trainer_launches(trainer, epochs: int, n_val: int):
    """The launches a yolo11n Trainer run makes: one attention forward and
    one backward a train step, one forward and one NMS a val batch, and one
    augmentation kernel a train step where the Trainer augments on the card
    by the kernel's route."""
    from deal_yolo_daya_tpu_torch.train.device_augment import route

    steps = epochs * len(trainer.train_loader)
    on_card = trainer.cfg.device_augment and route(trainer.aug_cfg, trainer.state.device) == "kernel"
    return {"area_attention": steps + n_val, "area_attention_bwd": steps, "nms_suppress": n_val,
            "device_augment": steps if on_card else 0}


def trainer_run(cfg, label: str):
    """Phase 23: ``Trainer(cfg).train()`` with the counts at 0 just before
    and read just after, held to the run's steps and val batches; per epoch
    the train wall (steps to the loss read) and img/s, the validation wall,
    the losses and mAP; the time each checkpoint held the main thread; peak
    memory."""
    import csv

    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    clocks = {"train": [], "val": [], "ckpt": []}

    def timed(fn, sink, sync=False):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            clocks[sink].append(time.perf_counter() - t0)
            return out
        return run

    trainer._train_epoch = timed(trainer._train_epoch, "train", sync=True)
    trainer.validate = timed(trainer.validate, "val")
    trainer.save_checkpoint = timed(trainer.save_checkpoint, "ckpt")
    torch.cuda.reset_peak_memory_stats()
    aa.launches = aa.bwd_launches = ns.launches = dk.launches = 0
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches,
                "nms_suppress": ns.launches, "device_augment": dk.launches}
    with open(Path(result["save_dir"]) / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    per_epoch = len(trainer.train_loader)
    epochs = [{"epoch": int(r["epoch"]), "train_s": ts,
               "train_imgs_per_s": per_epoch * cfg.batch / ts,
               "box": float(r["train/box_loss"]), "cls": float(r["train/cls_loss"]),
               "dfl": float(r["train/dfl_loss"]), "map50": float(r["metrics/mAP50(B)"]),
               "map": float(r["metrics/mAP50-95(B)"])}
              for r, ts in zip(rows, clocks["train"])]
    for e in epochs:
        log(f"[trainer {label}] epoch {e['epoch']}: train {e['train_s']:.2f} s = "
            f"{e['train_imgs_per_s']:.1f} img/s; losses box {e['box']:.4f} cls {e['cls']:.4f} "
            f"dfl {e['dfl']:.4f}; mAP50 {e['map50']:.4f} mAP50-95 {e['map']:.4f}")
    ckpt_ms = [s * 1e3 for s in clocks["ckpt"]]
    log(f"[trainer {label}] {len(rows)} epochs in {wall:.1f} s; validations "
        f"{[round(s, 2) for s in clocks['val']]} s; a checkpoint held the main thread "
        f"{[round(v, 1) for v in ckpt_ms]} ms; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(all(math.isfinite(e[k]) for e in epochs for k in ("box", "cls", "dfl")),
          f"{label}: a non-finite loss")
    want = trainer_launches(trainer, len(rows), len(clocks["val"]) * len(trainer.val_loader))
    check(launches == want, f"{label}: launches {launches}, not {want}")
    return trainer, result, {
        "wall_s": wall, "epochs": epochs, "val_s": clocks["val"], "checkpoint_ms": ckpt_ms,
        "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def profiled_trainer_launches(cfg):
    """Phase 23's graphed Trainer once more, under torch.profiler: each
    kernel's launches on the card, found by name in the trace, against its
    counter over the same run (the card's profiler has dropped whole
    windows: an empty one is taken again, up to three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    names = {"area_attention": ("attention_bf16_kernel", "attention_f32_kernel"),
             "area_attention_bwd": ("bwd_query_rows",),
             "nms_suppress": ("nms_kernel", "nms_walk_global"),
             "device_augment": ("augment_pixels_kernel",)}
    for attempt in range(3):
        trainer = Trainer(dataclasses.replace(cfg, name=f"{cfg.name}_profiled{attempt}"))
        aa.launches = aa.bwd_launches = ns.launches = dk.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train()
            torch.cuda.synchronize()
        counted = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches,
                   "nms_suppress": ns.launches, "device_augment": dk.launches}
        rows = [(e.key, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if rows:
            break
        log("[trainer profiled] the profiler recorded no device time; another run")
    on_card = {k: sum(n for key, n in rows if any(w in key for w in words))
               for k, words in names.items()}
    log(f"[trainer profiled] the graphed Trainer under the profiler: kernel launches on the "
        f"card {on_card}, counters {counted}")
    check(on_card == counted, f"the profiler saw {on_card} launches, the counters {counted}")
    return {"on_card": on_card, "counted": counted}


def host_augment_epoch(cfg, label: str):
    """Phase 24: ``device_augment=False``: the host augmentation alone over
    one epoch (ms/img, the loader's 8 threads), then one Trainer epoch under
    the profiler (the card's idle share)."""
    import torch

    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    check(not trainer._uses_device_cache(), "device_augment=False did not stream")
    t0 = time.perf_counter()
    n = sum(len(b.images) for b in trainer.train_loader.epoch(0))
    aug_ms = (time.perf_counter() - t0) * 1e3 / n
    trainer.state.zero_loss_acc()
    rows, wall = profile_rows(lambda: trainer._train_epoch(0))
    busy = sum(r[2] for r in rows)
    losses = {k: v.item() / len(trainer.train_loader) for k, v in trainer.state.loss_acc.items()}
    log(f"[host augment] {n} images augmented on the host in {aug_ms:.2f} ms/img (8 threads); "
        f"one Trainer epoch under the profiler: wall {wall:.0f} ms, device busy {busy:.0f} ms, "
        f"idle {100 - 100 * busy / wall:.1f}%; mean losses {losses}")
    check(all(math.isfinite(v) for v in losses.values()), f"{label}: a non-finite loss")
    return {"host_augment_ms_per_img": aug_ms, "epoch_wall_ms": wall, "busy_ms": busy,
            "idle_share": 1 - busy / wall, "losses": losses}


def remat_checks(seed: int, card: str):
    """Phase 25: ``remat`` gradients in f32 at b4 (TF32 off) against the same
    step without it, and the forward kernel launched twice a step; the peak
    memory of one b32 bf16 step with and without."""
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.models.yolo11 import YOLO11, init_weights
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig, step_seed
    from deal_yolo_daya_tpu_torch.train.step_graph import WARMUP_RUNS, StepProgram

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    weights = small_box_head(init_weights(YOLO11(nc=80, scale="n"), seed).state_dict())
    imgs, *gt = small_gt_batch(make_train_batch(seed, 4, 640)[0], seed)
    x4, gt4 = torch.from_numpy(imgs).to(dev), [torch.from_numpy(a).to(dev) for a in gt]

    def step(remat):
        st = TrainState(TrainConfig(model="yolo11n", imgsz=640, amp=False, seed=seed, remat=remat),
                        nc=80, steps_per_epoch=100, device=dev, state_dict=weights)
        before = (aa.launches, aa.bwd_launches)
        st.step(x4, *gt4)
        torch.cuda.synchronize()
        return ({n: p.grad.clone() for n, p in st.model.named_parameters()},
                (aa.launches - before[0], aa.bwd_launches - before[1]))

    grads_r, launched_r = step(True)
    grads_p, launched_p = step(False)
    torch.backends.cudnn.allow_tf32 = True
    rtol, atol = GRAD_TOL
    worst = max((g - grads_p[n]).abs().max().item()
                / (rtol * grads_p[n].abs().max().item() + atol) for n, g in grads_r.items())
    check(launched_r == (2, 1) and launched_p == (1, 1),
          f"remat launched (forward, backward) {launched_r}, without {launched_p}")
    check(worst <= 1.0, f"remat gradients off by {worst:.3f} of the tolerance")
    x32, *gt32 = (torch.from_numpy(a).to(dev) for a in make_train_batch(seed, 32, 640))
    peaks = {}
    for remat in (False, True):  # a step's peak above the state and batch
        st = TrainState(TrainConfig(model="yolo11n", imgsz=640, amp=True, seed=seed,
                                    remat=remat), nc=80, steps_per_epoch=100, device=dev)
        st.step(x32, *gt32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st.step(x32, *gt32)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        del st
        torch.cuda.empty_cache()
    # remat under the graph: a b32 bf16 program's warm-up, capture and one
    # replay, then a profiled replay
    st = TrainState(TrainConfig(model="yolo11n", imgsz=640, amp=True, seed=seed, remat=True),
                    nc=80, steps_per_epoch=100, device=dev)
    cache = (x32, torch.full((32, 2), 640.0, device=dev), gt32[0], gt32[1].int(), gt32[2])
    k = WARMUP_RUNS + 1
    prog = StepProgram(st, cache, DeviceAugConfig(), 640, GRAPH_MAX_BOXES, 32)
    prog.run(np.stack([np.random.default_rng(seed + j).permutation(32) for j in range(k)]),
             [step_seed(seed, 0, j) for j in range(k)])
    rows, _ = profile_rows(lambda: prog.graphs[True].replay())
    replay = attention_launches(rows)
    total = st.loss_acc["box_loss"].item() + st.loss_acc["cls_loss"].item()
    check(replay == (2, 1) and math.isfinite(total),
          f"a remat replay launched (forward, backward) {replay}, loss {total}")
    del prog, st
    torch.cuda.empty_cache()
    log(f"[remat] f32 b4 gradients with remat vs without: worst {worst:.3f} of the tolerance "
        f"{GRAD_TOL}; attention launches a step (forward, backward) {launched_r} with, "
        f"{launched_p} without, {replay} in a replay of the graphed remat step; a b32 bf16 "
        f"step's peak memory above the state {peaks[True]:.2f} GB with, {peaks[False]:.2f} GB without ({card})")
    return {"grad_worst_of_tol": worst, "launches_per_step": launched_r,
            "replay_launches": replay, "peak_gb_remat": peaks[True], "peak_gb": peaks[False]}


def repeated_dataset(data_yaml: Path, root: Path, repeats: int) -> Path:
    """A dataset whose train split lists ``data_yaml``'s train images
    ``repeats`` times (symbolic links) and whose val split is its own."""
    import yaml

    src = Path(data_yaml).parent
    for kind in ("images", "labels"):
        (root / kind / "train").mkdir(parents=True)
        (root / kind / "val").symlink_to(src / kind / "val")
        for f in sorted((src / kind / "train").iterdir()):
            for r in range(repeats):
                (root / kind / "train" / f"r{r}_{f.name}").symlink_to(f)
    out = root / "data.yaml"
    out.write_text(yaml.safe_dump({**yaml.safe_load(Path(data_yaml).read_text()),
                                   "path": str(root)}, sort_keys=False))
    return out


def autobatch_run(cfg, card: str):
    """Phase 26: ``batch=-1`` -> the batch it picks; then the default
    Trainer's path at that batch: the train set on the card, two epochs of
    graphed steps (K = 2: the warm-up steps, the capture, replays) with
    validation after each while the graph's pool is held. Its need, as the
    probe counts it: the peak allocated over each epoch's steps, and at
    each validation the memory reserved with the cache emptied (the state,
    the train set, the graph's pool) plus validation's peak above what was
    allocated; against the limit the pick was made for."""
    import torch

    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    torch.cuda.empty_cache()
    limit = torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
    trainer = Trainer(cfg)
    picked = trainer.cfg.batch
    programs, steps_peaks, val_needs = [], [], []
    make_program, validate = trainer.step_program, trainer.validate

    def step_program():
        programs.append(make_program())
        return programs[-1]

    def measured_validate(*a, **kw):
        torch.cuda.synchronize()
        steps_peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.empty_cache()
        held, base = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = validate(*a, **kw)
        torch.cuda.synchronize()
        val_needs.append(held + torch.cuda.max_memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()
        return out

    trainer.step_program, trainer.validate = step_program, measured_validate
    torch.cuda.reset_peak_memory_stats()
    result = trainer.train()
    need = max(steps_peaks + val_needs)
    n_batches = len(trainer.train_loader)
    log(f"[autobatch] batch=-1 picked {picked}; {len(trainer.train_ds)} train images = "
        f"{n_batches} batches an epoch; the Trainer at it ({trainer.cfg.epochs} epochs, K = 2, "
        f"validation each epoch): mAP50 {result['metrics'].get('map50', 0.0):.4f}; steps' peak "
        f"allocated {[round(v / 1e9, 2) for v in steps_peaks]} GB, validation's need "
        f"{[round(v / 1e9, 2) for v in val_needs]} GB: {need / 1e9:.2f} GB, "
        f"{100 * need / max(limit, 1):.1f}% of the {limit / 1e9:.1f} GB free or held before "
        f"({card})")
    check(n_batches >= 2 and any(p.graphs for p in programs),
          f"autobatch: {n_batches} batches an epoch, no graph captured at batch {picked}")
    check(need <= limit, f"autobatch: the path at batch {picked} needs {need / 1e9:.2f} GB, "
          f"over the {limit / 1e9:.2f} GB limit")
    return {"batch": picked, "train_images": len(trainer.train_ds), "batches": n_batches,
            "steps_peak_gb": [v / 1e9 for v in steps_peaks],
            "val_need_gb": [v / 1e9 for v in val_needs], "need_gb": need / 1e9,
            "limit_gb": limit / 1e9}


def profile_steps_run(cfg):
    """Phase 27: ``profile_steps=2`` writes a Chrome trace of two replays of
    the step program (after its warm-up steps and capture) that holds the
    attention kernels, the phase stamps and the program's spans."""
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    result = trainer.train()
    trace = Path(result["save_dir"]) / "profile" / "trace.json"
    check(trace.exists(), "profile_steps wrote no trace")
    text = trace.read_text()
    found = {w: text.count(w) for w in ("attention_bf16_kernel", "bwd_query_rows",
                                         "dyd_stamp_", "dyd_span")}
    log(f"[profile_steps] {trace.name}: {trace.stat().st_size / 1e6:.1f} MB, kernel events "
        f"{found}")
    check(all(found.values()), f"the trace lacks some of {found}")
    return {"trace_mb": trace.stat().st_size / 1e6, "kernel_events": found}


def phase_stamp_checks(seed: int, card: str):
    """Phase 41: the phase stamps of yolo11n's b32/640 bf16 step graph
    (``ops/kernels/phase_stamp.py``). After the warm-up steps, the capture
    and a replay, two windows of STAMP_REPLAYS replays from counters set
    to 0. Untraced: six stamp launches a replay, the ring's count advanced
    by one a replay, the ring's rows in time order, its five phases
    (``phase_ms()``) summed within STAMP_SUM_TOL of the step's time by
    CUDA events, one ``train.stage`` and ``train.replay`` span a step.
    Under the profiler: the same counts; the trace's stamps in slot order,
    six a replay but for at most STAMP_TRACE_LOST of them that the
    profiler dropped (a window that lost some is taken again, up to three
    times); ``phase_ms()`` within STAMP_TRACE_TOL of the trace's phases
    over its last whole steps; and no other program-named kernel."""
    import re
    from statistics import mean, median

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deal_yolo_daya_tpu_torch import tracing
    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.ops.kernels import phase_stamp as ps
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig, step_seed
    from deal_yolo_daya_tpu_torch.train.step_graph import WARMUP_RUNS, StepProgram

    dev = torch.device("cuda")
    x32, *gt32 = (torch.from_numpy(a).to(dev) for a in make_train_batch(seed, 32, 640))
    st = TrainState(TrainConfig(model="yolo11n", imgsz=640, amp=True, seed=seed), nc=80,
                    steps_per_epoch=100, device=dev)
    cache = (x32, torch.full((32, 2), 640.0, device=dev), gt32[0], gt32[1].int(), gt32[2])
    prog = StepProgram(st, cache, DeviceAugConfig(), 640, GRAPH_MAX_BOXES, 32)
    rng = np.random.default_rng(seed)
    done = [0]
    n, slots = STAMP_REPLAYS, len(ps.STAMPS)

    def run(k):
        prog.run(np.stack([rng.permutation(32) for _ in range(k)]),
                 [step_seed(seed, 0, done[0] + j) for j in range(k)])
        done[0] += k

    def count():
        return int(prog.stamps.buf[-1].item())

    def spans():
        return {k: v for k, v in tracing.totals().items() if k in ("train.stage", "train.replay")}

    run(WARMUP_RUNS + 1)  # the eager warm-up steps, the capture and a replay
    torch.cuda.synchronize()
    check(list(prog.graphs) == [True] and count() == WARMUP_RUNS + 1,
          f"stamps: {count()} steps in the ring after {WARMUP_RUNS} eager steps and a replay")

    # untraced
    ps.launches, dk.launches, before, spans0 = 0, 0, count(), spans()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run(n)
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b) / n
    launches, advanced, ring = ps.launches, count() - before, prog.phase_ms()
    aug_launches = dk.launches
    span_n = {k: v.count - spans0[k].count for k, v in spans().items()}
    span_ms = {k: (v.seconds - spans0[k].seconds) / n * 1e3 for k, v in spans().items()}
    host = prog.stamps.buf.cpu().numpy()
    c, rows = int(host[-1]), ps.RING_STEPS
    t = host[:-1].reshape(rows, slots)[[(c - rows + i) % rows for i in range(rows)]]
    check(launches == slots * n and advanced == n,
          f"stamps: {launches} launches and the ring advanced {advanced} over {n} replays")
    check(aug_launches == n, f"stamps: {aug_launches} augmentation kernel launches in {n} replays")
    check(bool((np.diff(t, axis=1) > 0).all() and (t[1:, 0] > t[:-1, -1]).all()),
          "stamps: the ring's rows are not in time order")
    ring_between = float(np.median(t[1:, 0] - t[:-1, -1])) / 1e6
    ring_sum = sum(ring.values())
    check(abs(ring_sum - step_ms) <= STAMP_SUM_TOL * step_ms,
          f"stamps: the ring's phases sum to {ring_sum:.3f} ms, the step takes {step_ms:.3f} ms")
    check(span_n == {"train.stage": n, "train.replay": n}, f"stamps: spans {span_n} in {n} steps")

    # under the profiler; a window that lost stamps is taken again (up to
    # three times)
    for _ in range(3):
        ps.launches, before = 0, count()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n)
            torch.cuda.synchronize()
        events = [e for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")]
        ev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), int(m.group(1)))
                    for e in events for m in [re.search(r"dyd_stamp_(\d)_", e.name())] if m)
        by_slot = [sum(1 for *_, k in ev if k == j) for j in range(slots)]
        if by_slot == [n] * slots:
            break
        log(f"[stamps] the profiler recorded stamps {by_slot} by slot for {n} replays; "
            "taking another window")
    check(ps.launches == slots * n and count() - before == n,
          f"stamps traced: {ps.launches} launches, the ring advanced {count() - before}")
    steps, i = [], 0  # whole steps: six stamps of slots 0..5 in a row
    while i + slots <= len(ev):
        if [k for *_, k in ev[i:i + slots]] == list(range(slots)):
            steps.append(ev[i:i + slots])
            i += slots
        else:
            i += 1
    lost = slots * n - len(ev)
    check(max(by_slot) <= n and lost <= STAMP_TRACE_LOST * slots * n and len(steps) >= n - lost,
          f"stamps: the trace holds {by_slot} by slot and {len(steps)} whole steps in slot "
          f"order for {n} replays")
    ring_t = prog.phase_ms()
    last = steps[-rows:]
    trace_ms = {p: median((s[k + 1][0] - s[k][1]) / 1e6 for s in last)
                for k, p in enumerate(ps.PHASES)}
    rel, floor = STAMP_TRACE_TOL
    worst = max(abs(ring_t[p] - trace_ms[p]) / max(rel * trace_ms[p], floor) for p in ps.PHASES)
    check(worst <= 1.0, f"stamps: phase_ms() {ring_t} against the trace's {trace_ms}")
    others = sorted({e.name() for e in events if e.name().startswith(
        ("train.", "serve.", "predict.")) or ("dyd" in e.name() and not
                                              re.search(r"dyd_stamp_\d_", e.name()))})
    check(not others, f"stamps: program-named device activities {others}")
    stamp_us = mean((e1 - e0) / 1e3 for e0, e1, _ in ev)
    del prog, st
    torch.cuda.empty_cache()
    log(f"[stamps] yolo11n b32 step graph, {n} replays: {launches} stamp launches, the ring "
        f"advanced {advanced}, {aug_launches} augmentation kernel launches; phase_ms() "
        f"{', '.join(f'{p} {v:.3f}' for p, v in ring.items())} "
        f"ms, sum {ring_sum:.3f} + {ring_between:.3f} between against {step_ms:.3f} ms a step "
        f"(CUDA events); host a step: stage {span_ms['train.stage']:.3f} ms, replay "
        f"{span_ms['train.replay']:.3f} ms; traced: {len(steps)} whole steps ({lost} stamps "
        f"lost), phase_ms() against the trace worst {worst:.3f} of the tolerance, a stamp "
        f"{stamp_us:.2f} us ({card})")
    return {"replays": n, "launches": launches, "ring_advanced": advanced, "step_ms": step_ms,
            "augment_launches": aug_launches,
            "ring_phase_ms": ring, "ring_between_ms": ring_between,
            "host_ms_per_step": span_ms, "ring_phase_ms_traced": ring_t,
            "trace_phase_ms": trace_ms, "trace_stamps_lost": lost, "worst_of_tol": worst,
            "stamp_us": stamp_us, "card": card}


def aug_canvases(seed: int, batch: int, imgsz: int, dev):
    """The Trainer's device-cache layout, made on the card: (B, S, S, 3) u8
    canvases, each a keep-ratio content of aspect (w / h) 0.5-2 with its
    long side S at the top left, smooth colour fields plus noise, 114
    around it; (B, 2) f32 content (h, w); AUG_BOXES boxes of 5-60% of the
    content's sides inside it, (B, M, 4) xyxy, int32 classes of 80 and a
    mask with 1-AUG_BOXES set, zeros beyond."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    aspect = 0.5 * 4.0 ** torch.rand((batch,), generator=g, device=dev)
    full = torch.full_like(aspect, float(imgsz))
    h = torch.where(aspect >= 1, imgsz / aspect, full).floor().clamp(min=1)
    w = torch.where(aspect >= 1, full, imgsz * aspect).floor().clamp(min=1)
    hw = torch.stack([h, w], 1)
    cells = imgsz // 16 + 1
    base = torch.randint(0, 256, (batch, cells, cells, 3), generator=g, device=dev,
                         dtype=torch.int16)
    images = base.repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :imgsz, :imgsz]
    noise = torch.randint(-20, 21, images.shape, generator=g, device=dev, dtype=torch.int16)
    images = (images + noise).clamp(0, 255).to(torch.uint8)
    ys = torch.arange(imgsz, device=dev)
    images[(ys[None, :, None] >= h[:, None, None]) | (ys[None, None, :] >= w[:, None, None])] = 114
    u = torch.rand((batch, AUG_BOXES, 4), generator=g, device=dev)
    wh = (0.05 + 0.55 * u[..., :2]) * hw.flip(-1)[:, None]
    xy = u[..., 2:] * (hw.flip(-1)[:, None] - wh)
    count = torch.randint(1, AUG_BOXES + 1, (batch, 1), generator=g, device=dev)
    mask = torch.arange(AUG_BOXES, device=dev)[None] < count
    classes = torch.randint(0, 80, (batch, AUG_BOXES), generator=g, device=dev,
                            dtype=torch.int32)
    return (images.contiguous(), hw, torch.cat([xy, xy + wh], -1) * mask[..., None],
            classes * mask, mask)


def device_augment_checks(seed: int, card: str):
    """Phase 42: the augmentation's pixel kernel (``csrc/device_augment.cu``)
    at b32/640 on ``aug_canvases``. For each of AUG_CASES, each ``apply``'s
    images against ``pixels_plain`` on the plan that call handed the
    kernel: one launch a call and none in ``pixels_plain``; the images
    within AUG_LEVELS on at most AUG_SHARE of the values; a data-parallel
    rank's boxes, classes, mask and images bit-equal to the whole batch's
    rows. Then ``apply`` captured into a CUDA graph: one launch a replay,
    counted at each replay, the replay's outputs those of the eager call.
    Times: the kernel (device time by CUDA events over a graph of launches,
    and a call), its plain version (``pixels_plain``) on the same plan,
    ``apply`` eager and as a replayed graph, against the bound (the sources
    read once and the u8 images written once)."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.train import device_augment as da
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig

    dev = torch.device("cuda")
    b, s = AUG_BATCH, AUG_IMGSZ
    raw = aug_canvases(seed, b, s, dev)
    plans = {}

    def recording(images, hw, plan):
        plans["last"] = (images, hw, plan)
        return orig(images, hw, plan)

    cases = {}
    with patched(dk, "launch", recording) as orig:
        for k, (name, kw, ranks) in enumerate(AUG_CASES):
            cfg = DeviceAugConfig(**kw)
            check(da.route(cfg, dev) == "kernel", f"augment {name}: route {da.route(cfg, dev)}")
            draws = da.draw(b, torch.Generator(device=dev).manual_seed(seed + k), cfg, dev)
            whole = da.apply(*raw, draws, s, cfg, AUG_MAX_BOXES)
            plans[name] = plans["last"]
            for r in range(ranks):
                rows = slice(r * b // ranks, (r + 1) * b // ranks) if ranks > 1 else None
                before = dk.launches
                got = da.apply(*raw, draws, s, cfg, AUG_MAX_BOXES, rows)
                launched = dk.launches - before
                # the plain version on the plan this call handed the kernel
                want = da.pixels_plain(*plans["last"], s, cfg)
                plain_launched = dk.launches - before - launched
                torch.cuda.synchronize()
                diff = (got[0].int() - want.int()).abs()
                levels, apart = int(diff.max()), int((diff > 0).sum())
                share = apart / diff.numel()
                # boxes, classes and mask take no part in the route: a rank's
                # are the whole batch's rows bit for bit
                labels = rows is None or all(same_bits(x, y[rows])
                                             for x, y in zip(got[1:], whole[1:]))
                own_rows = rows is None or torch.equal(got[0], whole[0][rows])
                label = name if ranks == 1 else f"{name}, rank {r}"
                log(f"[augment] {label}: kernel against pixels_plain on its plan, {apart} of "
                    f"{diff.numel()} values apart ({share:.2e}), at most {levels} level(s); "
                    f"boxes, classes and mask the whole batch's rows {labels}; "
                    f"{int(got[3].sum())} boxes kept; images the whole batch's rows {own_rows}; "
                    f"launches {launched} (pixels_plain {plain_launched})")
                check(launched == 1 and plain_launched == 0,
                      f"augment {label}: {launched} kernel launches, {plain_launched} in "
                      "pixels_plain")
                check(levels <= AUG_LEVELS and share <= AUG_SHARE,
                      f"augment {label}: images {apart} values apart, up to {levels} levels")
                check(labels, f"augment {label}: the rank's boxes, classes or mask differ "
                      "from the whole batch's")
                check(own_rows, f"augment {label}: the rank's images differ from the whole "
                      "batch's")
                cases[label] = {"values_apart": apart, "share": share, "max_levels": levels,
                                "labels_equal": labels, "launches": launched}

    # captured into a CUDA graph: one launch a replay
    cfg = DeviceAugConfig()
    draws = da.draw(b, torch.Generator(device=dev).manual_seed(seed), cfg, dev)
    eager = da.apply(*raw, draws, s, cfg, AUG_MAX_BOXES)
    replay, captured = capture_program(da.apply, (*raw, draws, s, cfg, AUG_MAX_BOXES))
    dk.launches = 0
    for _ in range(AUG_REPLAYS):
        replay()
    torch.cuda.synchronize()
    graph_launches = dk.launches
    same = all(same_bits(x, y) for x, y in zip(captured, eager))
    log(f"[augment] a CUDA graph of apply: {graph_launches} launches in {AUG_REPLAYS} "
        f"replays; the replay's outputs the eager call's {same}")
    check(graph_launches == AUG_REPLAYS,
          f"augment graph: {graph_launches} launches in {AUG_REPLAYS} replays")
    check(same, "augment graph: the replay's outputs differ from the eager call's")

    # times: the kernel and its plain version on the default case's plan;
    # the kernel's device time by CUDA events over a graph of launches, since
    # after phase 41 the card's profiler recorded no device activity at all
    # in six windows of 50 launches (a run of phase 42 alone recorded all)
    images, hw, plan = plans["default"]
    dev_ms = graph_time_ms(lambda: dk.launch(images, hw, plan))
    call_ms = cuda_time_ms(lambda: dk.launch(images, hw, plan), 200)
    mix_dev_ms = graph_time_ms(lambda: dk.launch(*plans["mixup 0.5"]))
    plain_ms = cuda_time_ms(lambda: da.pixels_plain(images, hw, plan, s, cfg), 10)
    apply_ms = cuda_time_ms(lambda: da.apply(*raw, draws, s, cfg, AUG_MAX_BOXES), 20)
    graph_ms = cuda_time_ms(replay, 50)
    nbytes = 2 * b * s * s * 3  # the sources read once, the u8 images written once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    del replay, captured
    torch.cuda.empty_cache()
    log(f"[time] device_augment ({b}, {s}) u8: kernel device {dev_ms:.4f} ms (a graph of "
        f"launches), a call {call_ms:.4f} ms with the host, {dev_ms / bound_ms:.1f} x its "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB); with mixup 0.5 device "
        f"{mix_dev_ms:.4f} ms; plain "
        f"pixels_plain {plain_ms:.3f} ms; apply {apply_ms:.3f} ms, as a replayed graph "
        f"{graph_ms:.3f} ms ({card})")
    return {"cases": cases, "graph_launches": graph_launches, "replays": AUG_REPLAYS,
            "shape": [b, s, s, 3], "device_ms": dev_ms, "call_ms": call_ms,
            "mixup_device_ms": mix_dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "apply_ms": apply_ms, "apply_graph_ms": graph_ms,
            "card": card}


# ---------------------------------------------------------------- phases 29-34


def same_bits(a, b) -> bool:
    """The same shape and the same bits (so -0.0 is not 0.0 and NaN is NaN)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(ints), b.contiguous().view(ints)))


def same_detections(got, want, what: str) -> None:
    """Two predict results with the same boxes, scores and classes, bit for bit."""
    import numpy as np

    check(len(got) == len(want) and all(
        len(g) == len(w) and np.array_equal(g.boxes, w.boxes)
        and np.array_equal(g.scores, w.scores) and np.array_equal(g.classes, w.classes)
        for g, w in zip(got, want)), f"{what}: the detections differ")


def s8_bound(x_shape, cout: int, k: int, stride: int, esize: int):
    """The s8 conv's least time on the card -> (ms, "bytes" or "operations",
    bytes, operations): the input read once, the weights (k*k*Cin bytes a
    row) and scales once, the output written once, at 3.35 TB/s; 2 int8
    operations a multiply-add at 1,979 TOP/s."""
    b, c, h, w = x_shape
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    nbytes = b * h * w * c * esize + cout * k * k * c + cout * 4 + b * ho * wo * cout * esize
    ops = 2.0 * b * ho * wo * cout * k * k * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph (after 3 on a side stream), its replays timed by CUDA events, over
    the calls, so no host launch cost sits between them. For the s8 conv,
    whose launches the card's profiler drops late in a run (it recorded 31,
    42, 44 and 36 of 50 back-to-back launches of one conv in four runs, and
    in one none of some path convs in three windows of 10, where a run of
    phases 29-32 alone recorded all)."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels._build import GraphLaunches

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), GraphLaunches().capture():  # the counters stay put
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def model_bytes(model) -> int:
    """The bytes of a model's parameters and buffers."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def int8_predict_phase(seed: int, images, bf16_handle):
    """Phase 29: phase 5's handle (class biases at 0), ``quantize_int8`` on
    its 64 images, calibrated on the card; the int8 raw head outputs
    against the fused model's on one b32 batch (INT8_HEAD_BAR held in f32,
    the bf16 figures printed); then predict with the counts at 0 just
    before and read just after (the s8 conv once a quantized conv,
    attention and NMS once, a batch), the first batch's conv inputs
    recorded; img/s end to end and device ms a b32 batch, int8 and bf16
    (phase 5's handle) in turn; the weights' bytes both ways."""
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.api import YOLO
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.ops.letterbox import letterbox_numpy

    from deal_yolo_daya_tpu_torch.models.quant import quantized_model
    from deal_yolo_daya_tpu_torch.models.yolo11 import fuse_conv_bn

    dev = torch.device("cuda")
    q11 = YOLO("yolo11n", nc=80, imgsz=640, seed=seed, device=dev)
    zero_class_bias(q11)  # conf 0.001 then keeps a dense candidate set, as in phase 5
    batch = torch.from_numpy(np.stack([letterbox_numpy(im, 640)[0] for im in images[:32]])).to(dev)
    x = batch.permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = {"bfloat16": q11._fused_model()(x.to(q11.dtype)),
               "float32": fuse_conv_bn(q11._model)(x.float() / 255.0)}
    bf16_bytes = model_bytes(q11._fused_model())
    t0 = time.perf_counter()
    q11.quantize_int8(images)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    net = q11._fused_model()
    with torch.no_grad():
        got = {"bfloat16": net(x.to(q11.dtype)),
               "float32": quantized_model(fuse_conv_bn(q11._model), q11._quant, torch.float32,
                                          dev)(x.float())}
    # the bar holds in f32, as the JAX test runs it, with the class biases at
    # 0: the random-weight logits spread ~1e-5 about their bias, so in bf16
    # near the box bias 1.0 (a step 2^-7), and in f32 at the class prior
    # (-8.8 at stride 32, a step 1e-6), the correlation would be the rounding
    # of both models, not the quantizer's (0.95 measured); bf16 is printed
    heads = []
    for dtype in ("float32", "bfloat16"):
        for kind, k in (("box", 0), ("cls", 1)):
            for level, (g, r) in enumerate(zip(got[dtype][k], ref[dtype][k])):
                a, b = g.float().flatten(), r.float().flatten()
                corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
                rel = ((a - b).abs().mean() / (b.abs().mean() + 1e-9)).item()
                heads.append({"dtype": dtype, "head": f"{kind}{level}",  # NaN: both constant
                              "corr": corr if math.isfinite(corr) else None,
                              "mean_rel_diff": rel})
    for dtype in ("float32", "bfloat16"):
        rows = [(h["head"], h["corr"] and round(h["corr"], 5), round(h["mean_rel_diff"], 5))
                for h in heads if h["dtype"] == dtype]
        log(f"[int8] raw heads vs the fused model in {dtype} on a b32 batch: {rows}"
            + (f" (bar: correlation > {INT8_HEAD_BAR[0]}, mean relative difference < "
               f"{INT8_HEAD_BAR[1]})" if dtype == "float32" else " (printed only)"))
    log(f"[int8] quantize_int8 on {len(images)} images in {quant_s:.2f} s: {len(q11._quant)} "
        f"convs int8")
    for h in (h for h in heads if h["dtype"] == "float32"):
        check((h["corr"] or 0.0) > INT8_HEAD_BAR[0] and h["mean_rel_diff"] < INT8_HEAD_BAR[1],
              f"int8 {h['head']} in f32: correlation {h['corr']}, mean relative difference "
              f"{h['mean_rel_diff']:.4f} (bar {INT8_HEAD_BAR})")
    int8_bytes = model_bytes(net)

    n_q = len(q11._quant)
    recorded = []

    def record(x, packed, scale, bias, inv_a, k, s, act):
        if len(recorded) < n_q:  # the first batch's calls
            recorded.append((x.clone(), packed, scale, bias, inv_a, k, s, act))
        return orig(x, packed, scale, bias, inv_a, k, s, act)

    with patched(ic, "int8_conv_bn", record) as orig:
        aa.launches = ns.launches = ic.launches = 0
        ic.tma_launches = ic.direct_launches = ic.narrow_launches = 0
        results = q11.predict(images, conf=0.001, batch_size=32)
        torch.cuda.synchronize()
        launches = {"int8_conv": ic.launches, "area_attention": aa.launches,
                    "nms_suppress": ns.launches,
                    **{f"int8_conv {rt}": getattr(ic, f"{rt}_launches") for rt in S8_ROUTES}}
    n_batches = -(-len(images) // 32)
    routes = [ic.plan_for(r[0], r[1].shape[0], r[5], r[6]).route for r in recorded]
    want = {"int8_conv": n_q * n_batches, "area_attention": n_batches,
            "nms_suppress": n_batches,
            **{f"int8_conv {rt}": routes.count(rt) * n_batches for rt in S8_ROUTES}}
    log(f"[int8] predict {len(results)} images at b32: launches {launches} ({n_q} quantized "
        f"ConvBNs by route {dict((rt, routes.count(rt)) for rt in S8_ROUTES)}, {n_batches} "
        f"batches)")
    check(launches == want, f"int8 predict launched {launches}, not {want}")
    check(len(recorded) == n_q, "the int8 predict did not go through every quantized conv")
    check(len(results) == len(images) and min(len(d) for d in results) > 0,
          "int8 predict lost images or detections")
    for d in results:
        check(np.isfinite(d.boxes).all() and np.isfinite(d.scores).all(), "non-finite int8 output")

    timing = {}
    for label, handle in (("int8", q11), ("bf16", bf16_handle), ("int8 again", q11),
                          ("bf16 again", bf16_handle)):
        device_ms = cuda_time_ms(lambda: handle.infer(batch, conf=0.001), 20)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            handle.predict(images, conf=0.001, batch_size=32)
            walls.append(time.perf_counter() - t0)
        timing[label] = {"imgs_per_s_e2e": len(images) / sorted(walls)[1],
                         "device_ms_per_b32": device_ms}
    log(f"[int8] predict b32 640 (int8, bf16, int8, bf16 in turn): "
        + "; ".join(f"{k} {v['imgs_per_s_e2e']:.1f} img/s end to end, device "
                    f"{v['device_ms_per_b32']:.3f} ms a b32 batch" for k, v in timing.items())
        + f"; weights {int8_bytes / 1e6:.3f} MB int8 against {bf16_bytes / 1e6:.3f} MB bf16")
    return q11, batch, recorded, {
        "quantized_convs": n_q, "quantize_s": quant_s, "heads_vs_bf16": heads,
        "launches": launches, "timing": timing, "weights_bytes": {"int8": int8_bytes,
                                                                  "bf16": bf16_bytes}}


def ulps_apart(a, b) -> int:
    """The largest distance in units in the last place between two float
    tensors of one dtype (bf16 or f32), by their ordered bit patterns."""
    import torch

    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    def ordered(t):
        v = t.contiguous().view(ints).to(torch.int64)
        top = 1 << (8 * t.element_size() - 1)
        return torch.where(v < 0, -(v + top), v)
    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() else 0


def dispatched_ops(net, x, inside=None):
    """The aten ops of one eager forward of ``net`` on ``x``, by op name
    (``add``, ``add_``, ``silu``, ...), caught by a TorchDispatchMode: ->
    (all ops, the ops dispatched inside a forward of a module of type
    ``inside``, the number of such forwards)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    depth = [0]
    seen = {"all": collections.Counter(), "inside": collections.Counter(), "calls": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            seen["all"][name] += 1
            if depth[0]:
                seen["inside"][name] += 1
            return func(*args, **(kwargs or {}))

    def enter(*_):
        depth[0] += 1
        seen["calls"] += 1

    def leave(*_):
        depth[0] -= 1

    hooks = []
    if inside is not None:
        for m in net.modules():
            if isinstance(m, inside):
                hooks += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    try:
        with torch.no_grad(), Count():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return seen["all"], seen["inside"], seen["calls"]


def s8_conv_checks(q11, batch, recorded, seed: int):
    """Phase 30: the fused s8 ConvBN kernels (``csrc/int8_conv.cu``) against
    their plain version (``int8_conv_bn_plain``) and against themselves (two
    launches): the s32 sums bit for bit, the output (scale, bias, SiLU) bit
    for bit or within S8_OUT_ULPS with its count, on every quantized
    ConvBN's input of phase 29's first batch (with its own act) and on edge
    shapes with and without act, bf16 and f32 (the stem's Cin 3, K = 27;
    Cin 8; Cout 8, 67, 80 and 300; B = 1; M no multiple of the 64-pixel
    tile; odd sizes at stride 2; Cin 48 with a 3x3 kernel; 1 x 1 images;
    1024 -> 512 at 3x3, too wide for the wgmma path's shared memory, on the
    narrow path; a base off the 16-byte alignment; a channel slice; inputs
    at +-127 steps, beyond, and on the k + 0.5 rounding ties). Then the
    times: the heaviest path conv (device time by CUDA graph, a call with
    the host, the plain version, cuDNN's bf16 conv, the bound), summed over
    a b32 batch's path convs, and ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32
    on the int8 input, a yardstick the port never calls) on the 1x1 convs."""
    import torch
    import torch.nn.functional as F

    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic

    dev = torch.device("cuda")
    diffs = {"checked": 0, "out_elements_differing": 0, "max_ulps": 0}

    def parity(label, x, packed, scale, bias, inv_a, k, s, act):
        y, acc = ic.launch(x, packed, scale, bias, inv_a, k, s, act, with_acc=True)
        y2, acc2 = ic.launch(x, packed, scale, bias, inv_a, k, s, act, with_acc=True)
        yp, accp = ic.int8_conv_bn_plain(x, packed, scale, bias, inv_a, k, s, act)
        torch.cuda.synchronize()
        twice = same_bits(acc, acc2) and same_bits(y, y2)
        check(same_bits(acc, accp.to(acc.dtype)), f"s8 conv {label}: the s32 sums differ from "
              f"the plain version's ({int((acc != accp).sum())} of {acc.numel()})")
        check(twice, f"s8 conv {label}: two launches differ")
        ints = {2: torch.int16, 4: torch.int32}[y.element_size()]
        differing = int((y.contiguous().view(ints) != yp.contiguous().view(ints)).sum())
        ulps = ulps_apart(y, yp)
        check(ulps <= S8_OUT_ULPS, f"s8 conv {label}: the output is {ulps} ulps from the plain "
              f"version's ({differing} elements differ; bound {S8_OUT_ULPS})")
        diffs["checked"] += y.numel()
        diffs["out_elements_differing"] += differing
        diffs["max_ulps"] = max(diffs["max_ulps"], ulps)
        return (y.float() - yp.float()).abs().max().item()

    errs = [parity(f"path conv {i} {tuple(r[0].shape)} -> {r[1].shape[0]} k{r[5]} s{r[6]} "
                   f"act {r[7]}", *r) for i, r in enumerate(recorded)]
    log(f"[s8 conv] {len(recorded)} path convs of a b32 batch: s32 sums bit for bit equal to "
        f"the plain version, two launches bit-identical; outputs: {diffs}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # (B, Cin, H, W, Cout, k, stride)
    edges = [(2, 3, 64, 64, 16, 3, 2), (1, 64, 20, 20, 67, 1, 1), (1, 16, 9, 7, 32, 3, 1),
             (2, 256, 10, 10, 80, 3, 2), (3, 20, 11, 13, 24, 3, 1), (1, 128, 1, 1, 64, 1, 1),
             (2, 8, 20, 20, 16, 3, 1), (2, 16, 20, 20, 8, 3, 1), (1, 32, 9, 11, 32, 1, 1),
             (2, 64, 19, 21, 64, 3, 2), (2, 16, 15, 13, 32, 3, 2), (2, 48, 12, 12, 64, 3, 1),
             (1, 64, 12, 12, 300, 3, 1), (2, 512, 10, 10, 256, 1, 1), (1, 1024, 6, 6, 512, 3, 1)]

    def inputs(b, c, h, w, n, k, dtype, offset=0, extra=0):
        a_scale = 0.05
        shape = (b, h, w, c + extra)
        steps = torch.randn(shape, generator=gen, device=dev) * 60
        pick = torch.randint(0, 4, shape, generator=gen, device=dev)
        edge = torch.tensor([127.0, -127.0, 200.0, -200.0], device=dev)[pick]
        half = torch.round(steps) + 0.5  # k + 0.5 steps: ties of the rounding
        sel = torch.randint(0, 3, shape, generator=gen, device=dev)
        vals = torch.where(sel == 0, steps, torch.where(sel == 1, edge, half))
        x = (vals * a_scale).to(dtype)
        if offset:  # the same values from a base `offset` elements past an aligned one
            flat = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
            flat[offset:] = x.flatten()
            x = flat[offset:].view(shape)
        x = x.permute(0, 3, 1, 2)[:, extra:]
        wq = torch.randint(-127, 128, (n, c, k, k), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-2 * a_scale
        bias = (torch.randn(n, generator=gen, device=dev) * 2).to(dtype)
        inv_a = float(torch.tensor(1.0) / torch.tensor(a_scale))
        return x, ic.pack_weight(wq), scale, bias, inv_a

    cases = [(e, 0, 0) for e in edges] + [((2, 64, 20, 20, 64, 3, 1), 3, 0),
                                          ((2, 32, 20, 20, 32, 3, 2), 1, 0),
                                          ((2, 32, 20, 20, 32, 3, 1), 0, 32),
                                          ((2, 8, 20, 20, 16, 3, 1), 0, 8)]
    for dtype in (torch.bfloat16, torch.float32):
        for (b, c, h, w, n, k, s), offset, extra in cases:
            x, packed, scale, bias, inv_a = inputs(b, c, h, w, n, k, dtype, offset, extra)
            for act in (True, False):
                errs.append(parity(f"edge {(b, c, h, w, n, k, s)} {dtype} act {act} base+"
                                   f"{offset} slice of {c + extra} "
                                   f"({ic.plan_for(x, n, k, s).route})", x,
                                   packed, scale, bias, inv_a, k, s, act))
    log(f"[s8 conv] {len(cases)} edge cases (base offsets and channel slices included) in bf16 "
        f"and f32, with and without act: s32 sums bit for bit, two launches bit-identical; "
        f"outputs over all checks: {diffs} (bound {S8_OUT_ULPS} ulps)")

    def macs(rec):
        x, packed, _, _, _, k, s, _ = rec
        return s8_bound(tuple(x.shape), packed.shape[0], k, s, x.element_size())[3]

    rec = max(recorded, key=macs)
    x, packed, scale, bias, inv_a, k, s, act = rec
    conv = lambda: ic.launch(*rec)  # noqa: E731
    ms = cuda_time_ms(conv, 200)
    dev_ms = graph_time_ms(conv)
    plain_ms = cuda_time_ms(lambda: ic.int8_conv_bn_plain(*rec), 5)
    w_bf16 = ic.unpack_weight(packed, x.shape[1], k).to(x.dtype).contiguous(
        memory_format=torch.channels_last)
    library = lambda: F.conv2d(x, w_bf16, stride=s, padding=k // 2)  # noqa: E731
    lib_ms = cuda_time_ms(library, 200)
    lib_dev_ms = graph_time_ms(library)
    bound, bound_by, nbytes, ops = s8_bound(tuple(x.shape), packed.shape[0], k, s,
                                            x.element_size())
    log(f"[time] int8_conv heaviest path conv {tuple(x.shape)} -> {packed.shape[0]} k{k} s{s} "
        f"{x.dtype} ({ic.plan_for(x, packed.shape[0], k, s).route}): kernel device {dev_ms:.4f} "
        f"ms (a CUDA graph of 20 launches), a call {ms:.4f} ms with the host; plain "
        f"{plain_ms:.4f} ms; cuDNN bf16 conv device {lib_dev_ms:.4f} ms, a call {lib_ms:.4f} ms; "
        f"bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.2f} GOP)")
    # summed over a b32 batch: each path conv's device time
    per_conv = [graph_time_ms(lambda r=r: ic.launch(*r), calls=10) for r in recorded]
    b32_ms = sum(per_conv)
    bounds = [s8_bound(tuple(r[0].shape), r[1].shape[0], r[5], r[6], r[0].element_size())[0]
              for r in recorded]
    routes = [ic.plan_for(r[0], r[1].shape[0], r[5], r[6]).route for r in recorded]
    by_route = {rt: {"convs": routes.count(rt),
                     "device_ms": sum(t for t, r in zip(per_conv, routes) if r == rt),
                     "bound_ms": sum(b for b, r in zip(bounds, routes) if r == rt)}
                for rt in sorted(set(routes))}
    infer_ms, _ = device_time_ms(lambda: q11.infer(batch, conf=0.001), calls=5)
    log(f"[time] int8_conv summed over a b32 batch's {len(recorded)} path convs: {b32_ms:.4f} ms "
        f"of device time (bound {sum(bounds):.4f} ms); by route "
        f"{by_route}; the whole int8 infer {infer_ms:.4f} ms (0: no whole profiler window)")
    # the library yardstick on the 1x1 convs: cuBLASLt's s8 GEMM on the
    # (M, Cin) int8 input (quantized beforehand) times the (Cin, Cout)
    # weights, s32 out: the products alone, no quantizer and no epilogue
    ones = [(i, r) for i, r in enumerate(recorded) if r[5] == 1 and r[6] == 1]
    mm_ms = []
    for i, r in ones:
        xr = r[0]
        xq = torch.clamp(torch.round(xr.float() * r[4]), -127, 127).to(torch.int8)
        a = xq.permute(0, 2, 3, 1).reshape(-1, xr.shape[1]).contiguous()
        wt = ic.unpack_weight(r[1], xr.shape[1], 1).reshape(r[1].shape[0], -1).contiguous().t()
        check(torch.equal(torch._int_mm(a, wt), ic.launch(*r, with_acc=True)[1].permute(
            0, 2, 3, 1).reshape(a.shape[0], -1)), f"torch._int_mm disagrees on 1x1 conv {i}")
        mm_ms.append(graph_time_ms(lambda a=a, wt=wt: torch._int_mm(a, wt), calls=10))
    heavy = max(range(len(ones)), key=lambda j: macs(ones[j][1]))
    int_mm = {"convs": len(ones), "device_ms": sum(mm_ms),
              "kernel_device_ms": sum(per_conv[i] for i, _ in ones),
              "bound_ms": sum(bounds[i] for i, _ in ones), "bound_by": "bytes"
              if all(s8_bound(tuple(r[0].shape), r[1].shape[0], 1, 1, r[0].element_size())[1]
                     == "bytes" for _, r in ones) else "mixed",
              "heaviest": [list(ones[heavy][1][0].shape), ones[heavy][1][1].shape[0]],
              "heaviest_device_ms": mm_ms[heavy],
              "heaviest_kernel_device_ms": per_conv[ones[heavy][0]]}
    log(f"[time] torch._int_mm (cuBLASLt s8 GEMM, s32 out, no quantizer or epilogue) on the "
        f"{len(ones)} 1x1 path convs: {int_mm}")
    return {
        "name": "int8_conv", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/int8_conv.cu",
        "replaces": "deal_yolo_daya_tpu/models/quant.py:64 (_int8_conv_call: XLA's int8 "
                    "lax.conv_general_dilated, no pallas_call; with the ConvBN's bias and SiLU)",
        "launches": None, "max_abs_err": max(errs), "tol": 0.0, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "library_device_ms": lib_dev_ms, "library": "cuDNN bf16 conv (F.conv2d)",
        "device_ms_from": "CUDA events around a CUDA graph of 20 launches",
        "shape": [list(x.shape), packed.shape[0], k, s], "dtype": str(x.dtype),
        "route_of_shape": ic.plan_for(x, packed.shape[0], k, s).route, "out_vs_plain": diffs,
        "b32_device_ms": b32_ms, "b32_device_ms_by_conv": per_conv, "b32_bound_ms": sum(bounds),
        "b32_by_route": by_route, "int_mm_1x1": int_mm, "b32_infer_device_ms": infer_ms or None,
        "path_convs": len(recorded), "edges": [list(c) for c in cases]}


def int8_engine_phase(q11, batch, bf16_handle, max_batch: int = 32):
    """Phase 31: an Engine over the int8 handle, one CUDA graph a bucket: the
    counts move by the eager warm-up runs at each capture; each replay is
    bit-identical to the eager int8 ``infer`` and adds its graph's launches
    (the s8 ConvBN once a quantized ConvBN, attention and NMS once); the ops
    one eager forward dispatches hold exactly no bias add or SiLU outside
    the s8 kernel; one profiled b32 replay shows the three kernels inside
    the graph and no more SiLU kernels than the bf16 ConvBNs left. Then the
    b32 replay's device time
    by CUDA events around back-to-back replays, int8 and bf16 (an Engine
    over phase 5's handle, bucket 32 alone) in turn: the profiler drops s8
    launches late in a run, events do not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deal_yolo_daya_tpu_torch import serve
    from deal_yolo_daya_tpu_torch.models.blocks import ConvBN
    from deal_yolo_daya_tpu_torch.models.quant import Int8ConvBN, Int8Detector
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as ic
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns

    def counts():
        return ic.launches, aa.launches, ns.launches

    per = (len(q11._quant), 1, 1)
    eng = serve.Engine(q11, max_batch=max_batch, conf=0.001, iou=0.7)
    check(isinstance(eng._net, Int8Detector), "the Engine does not serve the int8 model")
    caps = {}
    for b in eng.buckets():
        before = counts()
        eng.warmup([b])
        moved = tuple(a - z for a, z in zip(counts(), before))
        check(moved == tuple(serve.WARMUP_RUNS * n for n in per),
              f"int8 bucket {b}: warm-up and capture moved the counts by {moved}")
        prog = eng.program(b)
        caps[b] = {"capture_s": prog.capture_s, "pool_mb": prog.pool_bytes / 1e6}
    replays = {}
    for b in eng.buckets():
        prog = eng.program(b)
        prog.images.copy_(batch[:b])
        before = counts()
        prog.replay()
        got = [t.clone() for t in prog.outputs]
        moved = tuple(a - z for a, z in zip(counts(), before))
        want = q11.infer(batch[:b], conf=eng.conf, iou=eng.iou, max_det=eng.max_det)
        torch.cuda.synchronize()
        same = all(same_bits(g, w) for g, w in zip(got, want))
        check(moved == per, f"int8 bucket {b}: a replay counted {moved}, not {per}")
        check(same, f"int8 bucket {b}: the replay differs from the eager int8 infer")
        replays[b] = {"n_det": got[3].tolist()}
    captured = ", ".join(f"{b}: {c['capture_s'] * 1e3:.0f} ms, {c['pool_mb']:.0f} MB"
                         for b, c in caps.items())
    log(f"[serve int8] buckets {eng.buckets()} captured ({captured}); every replay "
        f"bit-identical to the eager int8 infer, counts {per} a replay")
    # no bias add or SiLU outside the s8 kernel, exactly: each Int8ConvBN
    # forward dispatches no arithmetic op of its own (one s8 launch, the
    # output's allocation and views), and the whole int8 forward dispatches
    # as many adds as the bf16 one (the residual and head adds) and as many
    # SiLUs less as there are quantized ConvBNs with act; the graphs replay
    # exactly these launches (the counters and bit-identical replays above)
    x2 = batch[:2].permute(0, 3, 1, 2)
    before = ic.launches
    ops8, inside, calls = dispatched_ops(eng._net, x2.to(q11.dtype), Int8ConvBN)
    s8_calls = ic.launches - before
    ops16 = dispatched_ops(bf16_handle._fused_model(), x2.to(bf16_handle.dtype))[0]
    n_act = sum(1 for m in eng._net.modules() if isinstance(m, Int8ConvBN) and m.act)

    def total(ops, word):
        return sum(v for op, v in ops.items() if op.rstrip("_") == word)

    dispatch = {"int8_add": total(ops8, "add"), "bf16_add": total(ops16, "add"),
                "int8_silu": total(ops8, "silu"), "bf16_silu": total(ops16, "silu"),
                "quantized_with_act": n_act, "int8convbn_forwards": calls, "s8_launches": s8_calls,
                "ops_inside_int8convbn": dict(inside)}
    log(f"[serve int8] ops dispatched by one eager forward (b2): {dispatch}")
    check(calls == per[0] and s8_calls == per[0],
          f"{calls} Int8ConvBN forwards launched {s8_calls} s8 kernels, not {per[0]}")
    check(set(inside) <= {"empty", "permute"}, f"an Int8ConvBN forward dispatched "
          f"{dict(inside)} beside its s8 launch: its bias or SiLU left the kernel")
    check(dispatch["int8_add"] == dispatch["bf16_add"],
          f"the int8 forward dispatched {dispatch['int8_add']} adds, the bf16 one "
          f"{dispatch['bf16_add']}: a quantized ConvBN's bias left its kernel")
    check(dispatch["int8_silu"] == dispatch["bf16_silu"] - n_act,
          f"the int8 forward dispatched {dispatch['int8_silu']} SiLUs, not the bf16 forward's "
          f"{dispatch['bf16_silu']} less its {n_act} quantized ConvBNs with act")
    prog = eng.program(max_batch)
    prog.replay()
    torch.cuda.synchronize()
    # the s8 ConvBN kernels by name; a SiLU runs only for the ConvBNs left
    # in bf16 (depthwise), none for the quantized ones, whose SiLU and bias
    # are in the kernel's epilogue (before, each quantized ConvBN also
    # launched an add and a SiLU)
    silu_want = sum(1 for m in eng._net.modules() if isinstance(m, ConvBN) and m.act)
    words = (("int8_conv", "s8_conv_"), ("attention", "attention_"), ("nms", "nms_"))
    for attempt in range(5):  # the card's profiler drops launches (graph_time_ms)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prog.replay()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        seen = tuple(sum(r[1] for r in rows if w in r[0]) for _, w in words)
        silu = sum(r[1] for r in rows if "silu" in r[0].lower())
        adds = sum(r[1] for r in rows if "add" in r[0].lower() and "s8_conv_" not in r[0])
        if seen == per and silu == silu_want:
            break
        time.sleep(1.0)
    ms = {site: sum(r[2] for r in rows if w in r[0]) for site, w in words}
    busy = sum(r[2] for r in rows)
    log(f"[serve int8] one replay of bucket {max_batch} under the profiler: launches "
        f"{dict(zip((s for s, _ in words), seen))} ({attempt + 1} windows; the counters: "
        f"{per}), SiLU kernels {silu} (the {silu_want} bf16 ConvBNs with act), add kernels "
        f"{adds}, {sum(r[1] for r in rows)} launches in all, device ms {ms}, busy {busy:.3f} ms")
    top = sorted(rows, key=lambda r: -r[2])[:12]
    log("[serve int8] the replay's kernels by device time: " + "; ".join(
        f"{c} x {k[:60]} {t:.4f} ms" for k, c, t in top))
    # the counters hold a replay's launches exactly (above); the profiler must
    # see each kernel inside the graph, and no launch the counters do not
    check(all(0 < n <= want for n, want in zip(seen, per)),
          f"the profiler saw {seen} launches in the int8 graph, the counters {per}")
    check(silu <= silu_want, f"the int8 replay ran {silu} SiLU kernels, beyond the {silu_want} "
          f"of the ConvBNs left in bf16: a quantized ConvBN's SiLU left its kernel")
    bf16_eng = serve.Engine(bf16_handle, max_batch=max_batch, conf=0.001, iou=0.7)
    bf16_eng.warmup([max_batch])
    progs = {"int8": prog, "bf16": bf16_eng.program(max_batch)}
    progs["bf16"].images.copy_(batch[:max_batch])

    def replay_ms(pr, n=20):
        for _ in range(3):
            pr.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            pr.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    replay_times = {}
    for label in ("int8", "bf16", "int8 again", "bf16 again"):
        replay_times[label] = replay_ms(progs[label.split()[0]])
    log(f"[serve int8] a b32 replay back to back (CUDA events, int8, bf16, int8, bf16 in "
        f"turn): " + ", ".join(f"{k} {v:.4f} ms" for k, v in replay_times.items()))
    bf16_eng.shutdown()
    eng.shutdown()
    return {"captures": caps, "replays": replays, "graph_launches": dict(zip(
        (s for s, _ in words), seen)), "graph_device_ms": ms, "graph_busy_ms": busy,
        "replay_ms_by_events": replay_times,
        "graph_silu_launches": silu, "graph_add_launches": adds, "dispatched": dispatch,
        "graph_all_launches": sum(r[1] for r in rows)}


def int8_export_phase(q11, images, out_dir):
    """Phase 32: ``export``/``from_export`` of the int8 handle: the loaded
    handle predicts bit for bit as its source."""
    import json as _json

    import torch

    from deal_yolo_daya_tpu_torch.api import YOLO

    bundle = q11.export(out_dir)
    meta = _json.loads((bundle / "meta.json").read_text())
    loaded = YOLO.from_export(bundle, device=torch.device("cuda"))
    check(meta["int8"] is True and sorted(loaded._quant) == sorted(q11._quant),
          "the int8 bundle lost its qtree")
    same_detections(loaded.predict(images[:32], conf=0.001, batch_size=32),
              q11.predict(images[:32], conf=0.001, batch_size=32), "int8 from_export")
    log(f"[export int8] {sorted(p.name for p in bundle.iterdir())}: from_export predicts bit for "
        f"bit as its source on 32 images")
    return {"files": sorted(p.name for p in bundle.iterdir())}


def ultralytics_phase(best_pt: Path, data_yaml: Path, root: Path, images, seed: int, cfg_cls):
    """Phase 33: phase 12's best.pt weights written as an ultralytics-layout
    checkpoint (tools/ultralytics_pt.py: fp16, a module tree of stand-in
    classes, names, an ``ema`` entry); ``YOLO.from_ultralytics`` predicts bit
    for bit as a handle loaded with the same fp16-rounded weights; then
    ``Trainer(model=<that .pt>)`` fine-tunes one epoch on phase 12's images
    under nc 4 (the intersect load), its launches held to its steps."""
    import torch
    import yaml

    from deal_yolo_daya_tpu_torch.api import YOLO

    spec = importlib.util.spec_from_file_location(
        "ultralytics_pt", Path(__file__).resolve().parent / "tools" / "ultralytics_pt.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    dev = torch.device("cuda")
    src = YOLO(str(best_pt), device=dev)
    sd = {k: v.detach().cpu() for k, v in src._model.state_dict().items()}
    upt = tool.write_checkpoint(root / "ultralytics_best.pt", sd, dict(enumerate(src.names)))
    check("ultralytics" not in sys.modules, "the stand-in classes stayed importable")
    u = YOLO.from_ultralytics(upt, imgsz=640, device=dev)
    check((u.family, u.scale, u.nc, u.names) == (src.family, src.scale, src.nc, src.names),
          "from_ultralytics lost the family, scale, nc or names")
    check(not u.import_report["missing"] and not u.import_report["shape_mismatch"],
          f"from_ultralytics import report {u.import_report}")
    ref = YOLO(f"{src.family}{src.scale}", nc=src.nc, imgsz=640, device=dev)
    ref._ensure_built().load_state_dict({k: v.half().float() for k, v in sd.items()},
                                        strict=True)
    same_detections(u.predict(images[:32], conf=0.001, batch_size=32),
              ref.predict(images[:32], conf=0.001, batch_size=32), "from_ultralytics")
    log(f"[ultralytics] {upt.name} ({upt.stat().st_size / 1e6:.2f} MB, fp16): from_ultralytics "
        f"imported {u.import_report['imported']} tensors, skipped "
        f"{len(u.import_report['skipped'])}; predicts bit for bit as the fp16-rounded weights")
    names = yaml.safe_load(Path(data_yaml).read_text())["names"]
    names = dict(enumerate(names)) if isinstance(names, list) else dict(names)
    data4 = Path(data_yaml).with_name("data_nc4.yaml")
    data4.write_text(yaml.safe_dump({**yaml.safe_load(Path(data_yaml).read_text()),
                                     "names": {**names, len(names): "extra"}}))
    cfg = cfg_cls(model=str(upt), data=str(data4), imgsz=640, batch=TRAINER_BATCH, epochs=1,
                  close_mosaic=0, seed=seed, device="0", project=str(root / "runs"),
                  name="ultralytics_ft", steps_per_dispatch=1)
    trainer, _, run = trainer_run(cfg, "from an ultralytics .pt, nc 4")
    report = trainer.import_report
    head = {f"{trainer.state.model.DETECT}.cv3.{i}.2.{p}" for i in range(3)
            for p in ("weight", "bias")}
    check(trainer.nc == 4 and head <= set(report["shape_mismatch"]) and all(
        k.startswith(f"{trainer.state.model.DETECT}.cv3.") for k in report["shape_mismatch"]),
        f"the fine-tune's report {report['shape_mismatch']} does not name the class head")
    log(f"[ultralytics] Trainer(model=<.pt>) at nc 4: imported {report['imported']} tensors, "
        f"{len(report['shape_mismatch'])} of the class head keep the fresh init "
        f"({sorted(report['shape_mismatch'])[:4]} ...); launches {run['launches']}")
    del trainer
    return {"imported": u.import_report["imported"], "fine_tune_launches": run["launches"],
            "fine_tune_shape_mismatch": report["shape_mismatch"],
            "fine_tune_epochs": run["epochs"]}


def int8_yardstick_phase(save_dir: Path, synth_yaml: Path, root: Path):
    """Phase 34: phase 28's trained yolo11n: ``val()`` in bf16, then
    ``quantize_int8`` on 64 of its train images, then ``val(int8=True)``;
    int8 mAP50-95 must reach INT8_MAP_SHARE of bf16's."""
    import torch

    from deal_yolo_daya_tpu_torch.api import YOLO

    ys = YOLO(str(Path(save_dir) / "weights" / "best.pt"), device=torch.device("cuda"))
    kw = dict(device="0", imgsz=ys.imgsz, project=str(root / "runs"))
    bf16 = ys.val(str(synth_yaml), name="yardstick_bf16", **kw)
    train = sorted((Path(synth_yaml).parent / "images" / "train").iterdir())[:64]
    ys.quantize_int8(train)
    int8 = ys.val(str(synth_yaml), int8=True, name="yardstick_int8", **kw)
    log(f"[yardstick int8] imgsz {ys.imgsz}: bf16 mAP50 {bf16['map50']:.4f} mAP50-95 "
        f"{bf16['map']:.4f}; int8 ({len(ys._quant)} convs, calibrated on {len(train)} train "
        f"images) mAP50 {int8['map50']:.4f} mAP50-95 {int8['map']:.4f}: "
        f"{int8['map'] / max(bf16['map'], 1e-9):.4f} of bf16 (floor {INT8_MAP_SHARE})")
    check(int8["map"] >= INT8_MAP_SHARE * bf16["map"], f"int8 mAP50-95 {int8['map']:.4f} is "
          f"below {INT8_MAP_SHARE} x bf16's {bf16['map']:.4f}")
    return {"bf16": {"map50": bf16["map50"], "map": bf16["map"]},
            "int8": {"map50": int8["map50"], "map": int8["map"]},
            "calibration_images": len(train)}


# ---------------------------------------------------------------- phase 35


def dp_gloo_rank(dp, cfg, state_dict, raw, seeds):
    """Phase 35, one of the two gloo ranks on the card: ``len(seeds)`` eager
    steps of ``dp_steps`` on this rank's rows of the raw batch (the on-card
    augmentation with the global draws), the attention kernels' inputs
    recorded and their launches counted from 0; then every recorded call
    held to the plain version -> this rank's record."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.parallel.dryrun import dp_steps
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig

    rec = {"fwd": [], "bwd": []}

    def rec_fwd(qkv, *a):
        rec["fwd"].append((qkv.clone(), a))
        return orig_fwd(qkv, *a)

    def rec_bwd(qkv, d_out, d_v, *a):
        rec["bwd"].append((qkv.clone(), d_out.clone(), d_v.clone(), a))
        return orig_bwd(qkv, d_out, d_v, *a)

    t0 = time.perf_counter()
    with patched(aa, "area_attention_fwd", rec_fwd) as orig_fwd, \
            patched(aa, "area_attention_bwd", rec_bwd) as orig_bwd:
        aa.launches = aa.bwd_launches = 0
        out = dp_steps(dp, cfg, 80, state_dict, raw, seeds, DeviceAugConfig())
        torch.cuda.synchronize()
        counts = (aa.launches, aa.bwd_launches)
    steps_s = time.perf_counter() - t0
    fwd_err = max(attention_parity(f"rank {dp.rank} train call {i}", q, a)
                  for i, (q, a) in enumerate(rec["fwd"]))
    bwd_err = max(backward_parity(f"rank {dp.rank} train call {i}", q, do, dv, a)
                  for i, (q, do, dv, a) in enumerate(rec["bwd"]))
    log(f"[dp gloo] rank {dp.rank} of {dp.world} on {dp.device}: {len(seeds)} steps in "
        f"{steps_s:.1f} s, attention launches (forward, backward) {counts}, qkv "
        f"{tuple(rec['fwd'][0][0].shape)}, kernel vs plain max |err| forward {fwd_err:.3e} "
        f"backward {bwd_err:.3e}")
    return {"rank": dp.rank, "launches": counts, "loss": out["loss"], "steps_s": steps_s,
            "stats": {k: v for k, v in out["state"].items() if "running_" in k},
            "qkv_shape": list(rec["fwd"][0][0].shape), "fwd_err": fwd_err, "bwd_err": bwd_err}


def replay_ms(prog, replays: int = DP_TIMED_REPLAYS) -> float:
    """CUDA events around ``replays`` back-to-back replays of a step
    program's update graph -> ms a replay."""
    import torch

    graph = prog.graphs[True]
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / replays


def dp_phase(seed: int, data_yaml: Path, root: Path, card: str, cfg_cls):
    """Phase 35: data parallelism on the one card (see the module docstring)
    -> its record."""
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.models.yolo11 import YOLO11, init_weights
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.parallel import launch
    from deal_yolo_daya_tpu_torch.parallel.dryrun import dp_steps
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.device_augment import (DeviceAugConfig, augment_batch,
                                                                step_seed)
    from deal_yolo_daya_tpu_torch.train.step_graph import StepProgram
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    imgsz, batch, k = 640, 32, DP_GRAPH_STEPS
    n_cache = 2 * batch
    images, boxes, classes, mask = make_train_batch(seed + 7, n_cache, imgsz)
    raw = (images, np.full((n_cache, 2), imgsz, np.float32), boxes, classes.astype(np.int32),
           mask)
    cache = tuple(torch.from_numpy(a).to(dev) for a in raw)
    rng = np.random.default_rng(seed + 9)
    idx = np.stack([rng.permutation(n_cache)[:batch] for _ in range(k)])
    seeds = [step_seed(seed, 0, j) for j in range(k)]
    aug = DeviceAugConfig()
    cfg = TrainConfig(model="yolo11n", imgsz=imgsz, amp=True, seed=seed,
                      max_boxes=GRAPH_MAX_BOXES)
    record = {"card": card}

    # 35.1 a one-rank NCCL group: the graphed distributed step against its
    # eager run, its time with and without the collectives, and an f32 step
    # against the one-card step
    t0 = time.perf_counter()
    ranks = launch.start_local(1, [dev])
    dp = ranks.dp
    log(f"[dp nccl] a 1-rank {dp.backend} group on {dp.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        def fresh(with_dp: bool):
            st = TrainState(cfg, nc=80, steps_per_epoch=100, device=dev)
            if with_dp:
                st.attach(dp)
            return st

        start = fresh(False).state()
        eager = fresh(True)
        # the group's collectives must run although it has one rank: count
        # the NCCL calls of the eager steps (SyncBatchNorm's moments, the loss
        # normaliser, the raw-batch gather, the gradient all-reduce)
        calls = collections.Counter()

        def counted(name):
            orig = getattr(torch.distributed, name)

            def call(*a, **kw):
                calls[name] += 1
                return orig(*a, **kw)
            return call

        with contextlib.ExitStack() as stack:
            for name in ("all_reduce", "all_gather_into_tensor"):
                stack.enter_context(patched(torch.distributed, name, counted(name)))
            for j in range(k):
                t = torch.from_numpy(idx[j]).to(dev)
                eager.step(*augment_batch(*(c[t] for c in cache), seeds[j], imgsz, aug,
                                          GRAPH_MAX_BOXES, dp=dp))
        synced = sum(getattr(m, "dp", None) is dp for m in eager.model.modules()
                     if hasattr(m, "update_stats"))
        log(f"[dp nccl] {k} eager steps in the 1-rank group: {dict(calls)} collective calls, "
            f"{synced} BatchNorms synchronised over the group")
        check(synced > 0 and calls["all_reduce"] >= k and calls["all_gather_into_tensor"] >= k,
              f"the 1-rank group ran without its collectives: {dict(calls)}, {synced} BNs")
        graphed = fresh(True)
        prog = StepProgram(graphed, cache, aug, imgsz, GRAPH_MAX_BOXES, batch)
        aa.launches = aa.bwd_launches = 0
        prog.run(idx, seeds)
        torch.cuda.synchronize()
        first = (aa.launches, aa.bwd_launches)
        diffs = state_diffs(graphed, eager, start)
        same_loss = all(torch.equal(graphed.loss_acc[n], eager.loss_acc[n])
                        for n in graphed.loss_acc)
        log(f"[dp nccl] {k} steps b{batch} {imgsz} bf16, graphed (K = {k}, the collectives "
            f"captured) vs eager in the group: max |diff| "
            f"{ {kind: d['max_abs_diff'] for kind, d in diffs.items()} }, loss sums equal "
            f"{same_loss}; capture {prog.capture_s:.2f} s")
        check(same_loss and all(d["max_abs_diff"] == 0.0 for d in diffs.values()),
              "the graphed distributed steps differ from their eager run")
        check(first == (k, k), f"the first dispatch counted {first} attention launches, "
              f"not {(k, k)}")
        aa.launches = aa.bwd_launches = 0
        prog.run(idx, seeds)  # replays only
        torch.cuda.synchronize()
        replays = (aa.launches, aa.bwd_launches)
        check(replays == (k, k), f"{k} replays counted {replays} attention launches")
        # the same step without the collectives: the one-card program
        plain = StepProgram(fresh(False), cache, aug, imgsz, GRAPH_MAX_BOXES, batch)
        plain.run(idx, seeds)
        with_c, without_c = [], []
        for _ in range(3):
            with_c.append(replay_ms(prog))
            without_c.append(replay_ms(plain))
        step_ms, plain_ms = float(np.median(with_c)), float(np.median(without_c))
        log(f"[dp nccl] graphed step b{batch} {imgsz}: {step_ms:.3f} ms with the collectives "
            f"(1-rank NCCL), {plain_ms:.3f} ms on one card without them: overhead "
            f"{step_ms - plain_ms:.3f} ms; rounds {[round(v, 3) for v in with_c]} vs "
            f"{[round(v, 3) for v in without_c]} ({card})")
        del prog, plain, graphed, eager
        torch.cuda.empty_cache()

        # f32, TF32 off: one step of the 1-rank group against the one-card
        # step, from the same weights on phase 9's kind of batch
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg32 = TrainConfig(model="yolo11n", imgsz=imgsz, amp=False, seed=seed)
        weights = small_box_head(init_weights(YOLO11(nc=80, scale="n"), seed).state_dict())
        imgs4, *gt4 = small_gt_batch(make_train_batch(seed, 4, imgsz)[0].copy(), seed)
        x4, gt4 = torch.from_numpy(imgs4).to(dev), [torch.from_numpy(a).to(dev) for a in gt4]

        def f32_step(with_dp: bool, stem_ulps: float = 0.0):
            st = TrainState(cfg32, nc=80, steps_per_epoch=100, device=dev, state_dict=weights)
            if stem_ulps:
                with torch.no_grad():
                    w = st.model.get_parameter("0.conv.weight")
                    w.mul_(1 + stem_ulps * np.finfo(np.float32).eps)
            if with_dp:
                st.attach(dp)
            st.step(x4, *gt4)
            torch.cuda.synchronize()
            out = {"loss": {n: v.item() for n, v in st.loss_acc.items()},
                   "grads": {n: p.grad.detach().cpu() for n, p in st.model.named_parameters()},
                   "state": {n: v.detach().cpu() for n, v in st.model.state_dict().items()}}
            st.detach()
            return out

        def outside(a, b):
            """The tensors whose gradients lie outside rtol / atol of DP_F32_GRAD_TOL."""
            return [n for n in b["grads"] if not torch.allclose(
                a["grads"][n], b["grads"][n], rtol=DP_F32_GRAD_TOL[0], atol=DP_F32_GRAD_TOL[1])]

        def worst_of_floor(part, floor):
            """max over tensors of |group - one card| / (2 x |nudged - one
            card| + floor(tensor)): above 1, the group moved a tensor farther
            than twice the one-card step's own sensitivity and the bar."""
            return max(((two[part][n] - one[part][n]).abs().max()
                        / (2 * (nudged[part][n] - one[part][n]).abs().max() + floor(one[part][n])))
                       .item() for n in one[part])

        one, two, nudged = f32_step(False), f32_step(True), f32_step(False, 1.0)
        loss_rel = max(abs(two["loss"][n] - one["loss"][n]) / max(abs(one["loss"][n]), 1e-30)
                       for n in one["loss"])
        grad_rel = max(((two["grads"][n] - one["grads"][n]).abs().max()
                        / one["grads"][n].abs().max().clamp(min=1e-30)).item()
                       for n in one["grads"])
        state_abs = max((two["state"][n] - one["state"][n]).abs().max().item()
                        for n in one["state"])
        grad_worst = worst_of_floor("grads", lambda t: DP_F32_GRAD_TOL[1]
                                    + DP_F32_GRAD_TOL[0] * t.abs().max())
        state_worst = worst_of_floor("state", lambda t: DP_F32_STATE_ATOL + DP_F32_STATE_ULPS
                                     * np.finfo(np.float32).eps * t.abs().max())
        out_dp, out_nudge = outside(two, one), outside(nudged, one)
        log(f"[dp nccl] f32 b4 {imgsz}, TF32 off, one step: 1-rank group vs one card: loss "
            f"parts max rel {loss_rel:.3e}, gradients max |diff| / max |grad| {grad_rel:.3e}, "
            f"{len(out_dp)} of {len(one['grads'])} tensors outside rtol "
            f"{DP_F32_GRAD_TOL[0]} / atol {DP_F32_GRAD_TOL[1]}; parameters and BN statistics "
            f"max |diff| {state_abs:.3e}. The one-card step with the stem kernel moved by one "
            f"ulp: {len(out_nudge)} tensors outside the same bar. The group's largest move "
            f"against twice the nudge's plus the bar: gradients {grad_worst:.3f}, state "
            f"{state_worst:.3f}")
        check(loss_rel <= DP_F32_LOSS_RTOL, f"f32 loss parts of the group off by {loss_rel}")
        check(grad_worst <= 1.0, f"f32 gradients of the group off: {grad_worst:.3f} of the floor")
        check(state_worst <= 1.0, f"f32 state of the group off: {state_worst:.3f} of the floor")
        record["nccl_1rank"] = {
            "eager_collective_calls": dict(calls), "bn_synchronised": synced,
            "graphed_vs_eager": diffs, "loss_sums_equal": same_loss,
            "launches_first_dispatch": first, "launches_replays": replays,
            "graphed_step_ms_with_collectives": step_ms,
            "graphed_step_ms_without": plain_ms, "collective_overhead_ms": step_ms - plain_ms,
            "rounds_ms": {"with": with_c, "without": without_c},
            "f32_vs_one_card": {"loss_max_rel": loss_rel, "grad_max_rel_of_max": grad_rel,
                                "grads_outside": len(out_dp), "state_max_abs": state_abs,
                                "one_ulp_stem_outside": len(out_nudge),
                                "grad_worst_of_floor": grad_worst,
                                "state_worst_of_floor": state_worst}}
    finally:
        ranks.close()

    # 35.2 two gloo ranks on the one card (b16 each) against one process on
    # the b32 batch, DP_STEPS eager steps from one state, bf16
    sd = {n: v.cpu() for n, v in TrainState(cfg, nc=80, steps_per_epoch=100, device=dev)
          .state()["model"].items()}
    sub = tuple(a[:batch] for a in raw)
    dp_seeds = [step_seed(seed, 1, j) for j in range(DP_STEPS)]
    t0 = time.perf_counter()
    one = dp_steps(None, cfg, 80, sd, sub, dp_seeds, aug, device=dev)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = launch.run(dp_gloo_rank, 2, [dev, dev], args=(cfg, sd, sub, dp_seeds),
                      backend="gloo", timeout_s=600.0)
    gloo_s = time.perf_counter() - t0
    loss_rel = {n: abs(gloo[0]["loss"][n] - one["loss"][n]) / abs(one["loss"][n])
                for n in ("box_loss", "cls_loss", "dfl_loss")}
    stats = [n for n in one["state"] if "running_" in n]
    stat_diff = max(float(np.abs(gloo[0]["stats"][n] - one["state"][n]).max()) for n in stats)
    stat_move = max(float(np.abs(one["state"][n] - sd[n].numpy()).max()) for n in stats)
    log(f"[dp gloo] 2 ranks x b{batch // 2} vs one process b{batch}, {DP_STEPS} bf16 steps "
        f"({one_s:.1f} s one process, {gloo_s:.1f} s the two ranks with the spawn): loss "
        f"parts rel diff {loss_rel} (num_fg {gloo[0]['loss']['num_fg']} vs "
        f"{one['loss']['num_fg']}), BN statistics max |diff| {stat_diff:.3e} of the largest "
        f"move {stat_move:.3e}; launches per rank {[r['launches'] for r in gloo]}")
    check(max(loss_rel.values()) <= DP_BF16_LOSS_RTOL, f"gloo ranks' loss parts off: {loss_rel}")
    check(stat_diff <= DP_BF16_STATS_TOL * stat_move, "gloo ranks' BN statistics off by "
          f"{stat_diff} of a move {stat_move}")
    check(all(tuple(r["launches"]) == (DP_STEPS, DP_STEPS) for r in gloo),
          f"per-rank attention launches {[r['launches'] for r in gloo]}, not 1 + 1 a step")
    check(all(np.array_equal(gloo[0]["stats"][n], gloo[1]["stats"][n]) for n in stats),
          "the two ranks' BN statistics differ")
    record["gloo_2ranks"] = {
        "batch_per_rank": batch // 2, "steps": DP_STEPS, "loss_rel_diff": loss_rel,
        "bn_stats_max_abs_diff": stat_diff, "bn_stats_max_move": stat_move,
        "launches_per_rank": {str(r["rank"]): r["launches"] for r in gloo},
        "kernel_vs_plain_per_rank": {str(r["rank"]): {"forward": r["fwd_err"],
                                                      "backward": r["bwd_err"]} for r in gloo},
        "qkv_shape": gloo[0]["qkv_shape"], "one_process_s": one_s, "two_ranks_s": gloo_s}

    # 35.3 the Trainer with device="1" against device="0" on phase 12's data,
    # one epoch; "2" on one card raises the JAX ValueError
    base = cfg_cls(model="yolo11n", data=str(data_yaml), imgsz=640, batch=TRAINER_BATCH,
                   epochs=1, close_mosaic=0, seed=seed, project=str(root / "runs"))
    rows = {}
    for spec in ("0", "1"):
        res = Trainer(dataclasses.replace(base, name=f"dp_device{spec}", device=spec)).train()
        with open(Path(res["save_dir"]) / "results.csv") as f:
            rows[spec] = [{c: v for c, v in r.items() if c != "time"} for r in csv.DictReader(f)]
        torch.cuda.empty_cache()
    check(rows["0"] == rows["1"], f"device='1' gave {rows['1']}, device='0' {rows['0']}")
    try:
        Trainer(dataclasses.replace(base, name="dp_device2", device="2"))
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised == "mesh 2x1 needs 2 devices, only 1 available",
          f"device='2' on one card: {raised!r}")
    log(f"[dp trainer] device='1' and device='0' wrote the same results.csv row "
        f"{rows['1'][0]}; device='2' raised {raised!r}")
    record["trainer"] = {"rows_equal": True, "row": rows["1"][0], "device2_error": raised}
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[dp] phase 35 in {record['wall_s']:.1f} s")
    return record


# ---------------------------------------------------------------- phase 36


def page_launches(n_train: int, n_val: int, batch: int, epochs: int):
    """The launches the training page's yolo11n run makes: one attention
    forward and backward a train step (whole batches), one forward and one
    NMS a validation batch, validating after each epoch and once at the
    end."""
    steps = epochs * max(n_train // batch, 1)
    val_batches = (epochs + 1) * -(-n_val // batch)
    return {"area_attention": steps + val_batches, "area_attention_bwd": steps,
            "nms_suppress": val_batches}


def app_phase(seed: int, root: Path, card: str):
    """Phase 36: the data pipeline and the app's call paths (see the module
    docstring) -> its record."""
    import queue
    import threading

    import torch

    from deal_yolo_daya_tpu_torch import runtime
    from deal_yolo_daya_tpu_torch.core import processor
    from deal_yolo_daya_tpu_torch.core import training as core_training
    from deal_yolo_daya_tpu_torch.core import utils as core_utils
    from deal_yolo_daya_tpu_torch.datakit import boxes as box_ops
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.train.data import YoloDataset

    here = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "synth_annotations_torch", here / "tools" / "synth_annotations_torch.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    t_phase = time.perf_counter()
    record = {"card": card}

    # 36a. the probes the pages make, and the native scanner
    missing, missing_train = core_utils.check_requirements(), core_training.check_train_dependencies()
    summary = core_utils.get_cuda_summary()
    lib = runtime.get_lib()
    log(f"[app] check_requirements {missing}, check_train_dependencies {missing_train}; "
        f"device summary {summary}; native scanner {lib._name if lib else None}")
    check(missing == [] and missing_train == [], f"missing modules {missing} {missing_train}")
    check(summary.get("available") is True and summary.get("platform") == "gpu",
          f"the device summary names no card: {summary}")
    check(lib is not None and Path(lib._name).parent == runtime.BUILD,
          "the native label scanner did not build into _build/ or load")
    record["probes"] = {"summary": summary, "library": Path(lib._name).name}

    # 36b. the golden chain at 300 rows, then its wall at APP_CHAIN_ROWS
    golden = json.loads((here / "tests" / "golden" / "datakit_chain_hashes.json").read_text())
    chain = root / "app_chain"
    chain.mkdir()
    synth.run_chain(chain, 300)
    hashes = synth.artifact_hashes(chain)
    differ = sorted(k for k in set(golden) | set(hashes) if golden.get(k) != hashes.get(k))
    log(f"[app] golden chain at 300 rows: {len(golden) - len(differ)} of {len(golden)} "
        f"artifacts equal the golden hashes; differing {differ}")
    check(not differ, f"the chain's artifacts differ from the golden hashes: {differ}")
    big = root / "app_chain_big"
    big.mkdir()
    chain_s = synth.run_chain(big, APP_CHAIN_ROWS)
    log(f"[app] steps 4-7 on {APP_CHAIN_ROWS} rows (host): {sum(chain_s.values()):.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in chain_s.items())}); {card}")
    record["golden"] = {"artifacts": len(golden), "differ": differ}
    record["chain"] = {"rows": APP_CHAIN_ROWS, "seconds": chain_s,
                       "total_s": sum(chain_s.values())}

    # 36c. the nine steps through core.processor, as the processing page calls them
    t0 = time.perf_counter()
    fx = synth.pipeline_inputs(root / "app_pipeline", n_images=APP_IMAGES, seed=seed)
    inputs_s = time.perf_counter() - t0
    run = synth.run_pipeline(processor, fx, root / "app_pipeline" / "run")
    log(f"[app] nine steps on {fx['counts']['merged']} raw rows of {APP_IMAGES} local PNG "
        f"sources (written in {inputs_s:.1f} s): {run['counts']}; seconds "
        f"{ {k: round(v, 3) for k, v in run['seconds'].items()} }")
    check(run["counts"] == fx["counts"], f"row counts {run['counts']}, not {fx['counts']}")
    for name, ds_dir in run["datasets"].items():
        for split, n in fx["counts"]["yolo_images"][name].items():
            ds = YoloDataset.from_yaml(str(ds_dir / "data.yaml"), split)
            check(len(ds) == n and all(len(lab) for lab in ds.labels),
                  f"{name}/{split}: train/data.py read {len(ds)} images, not {n} with labels")
    drawn = sorted((root / "app_pipeline" / "run" / "annotated_images").iterdir())
    check(len(drawn) == synth.MAX_DRAWN, f"step 9 drew {len(drawn)} images")
    data_yaml = run["datasets"]["animals"] / "data.yaml"
    record["pipeline"] = {"counts": run["counts"], "seconds": run["seconds"],
                          "inputs_s": inputs_s}

    # 36d. the IoU filter on the card against numpy, whole calls timed by
    # CUDA events (the host-to-device copy included)
    record["iou"] = []
    for n_rows, width in APP_IOU_TABLES:
        b, m, planted = synth.planted_iou_table(n_rows, width, seed=seed)
        t0 = time.perf_counter()
        ref = box_ops._high_iou_hits_numpy(b, m, 2, 0.98)
        host_ms = (time.perf_counter() - t0) * 1e3
        times = []
        with patched(box_ops, "JAX_MIN_ROWS", 0):
            for _ in range(2):  # the first call, then a warm one
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                got = box_ops.high_iou_hits(b, m)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                bad = int((got != ref).sum())
                check(bad == 0, f"IoU filter {n_rows} x {width}: {bad} flags differ from numpy")
        kinds = {k: int(v.size) for k, v in planted.items()}
        for kind, rows in planted.items():
            check(bool((ref[rows] == synth.PLANTED_HIT[kind]).all()),
                  f"IoU filter {n_rows} x {width}: planted {kind} rows flagged wrongly")
        log(f"[app iou] {n_rows} x {width} ({b.nbytes / 2**20:.0f} MiB of boxes): "
            f"{int(ref.sum())} hits, flag for flag equal to numpy; planted {kinds}; card "
            f"{times[0]:.2f} ms first, {times[1]:.2f} ms warm; numpy {host_ms:.1f} ms; {card}")
        record["iou"].append({"rows": n_rows, "width": width, "hits": int(ref.sum()),
                              "planted": kinds, "card_ms": times, "numpy_ms": host_ms})
        del b, m, ref, got

    # 36e. the training page's call path: run_yolo_training_stream in a
    # thread with the page's kwargs, its queue drained to LOG_DONE
    project = root / "app_runs"
    kwargs = synth.page_train_kwargs(str(project), "page", epochs=APP_EPOCHS,
                                     imgsz=APP_IMGSZ, batch=APP_BATCH, device=APP_DEVICE)
    counts = fx["counts"]["yolo_images"]["animals"]
    want = page_launches(counts["train"], counts["val"], APP_BATCH, APP_EPOCHS)
    log_queue, holder, lines = queue.Queue(), {}, []
    aa.launches = aa.bwd_launches = ns.launches = 0
    thread = threading.Thread(target=core_training.run_yolo_training_stream, daemon=True, args=(
        "yolo11n", str(data_yaml), kwargs, {}, log_queue, holder))
    t0 = time.perf_counter()
    thread.start()
    while True:  # nothing is printed here: the thread redirects this process's stdout
        item = log_queue.get(timeout=APP_LINE_TIMEOUT_S)
        if item is core_training.LOG_DONE:
            break
        lines.append((time.perf_counter() - t0, item))
    thread.join(timeout=60)
    wall = time.perf_counter() - t0
    launches = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches,
                "nms_suppress": ns.launches}
    for t, line in lines:
        log(f"[app log {t:7.2f} s] {line}")
    epochs = [(t, core_training._extract_epoch_info(line), line) for t, line in lines
              if core_training._extract_epoch_info(line)]
    check("error" not in holder, f"the page's run failed: {holder.get('error')!r}")
    check([e for _, e, _ in epochs] == [(i + 1, APP_EPOCHS) for i in range(APP_EPOCHS)],
          f"epoch lines {[e for _, e, _ in epochs]}")
    save_dir = Path(holder["save_dir"])
    for name in ("results.csv", "args.yaml", "weights/last.pt", "weights/best.pt"):
        check((save_dir / name).exists(), f"the page's run wrote no {name}")
    found = core_training.collect_run_dirs(str(project))
    check(found == [save_dir.resolve()], f"collect_run_dirs found {found}")
    check(launches == want, f"the page's run launched {launches}, not {want}")
    img_s = [float(line.rsplit(" ", 2)[-2]) for _, _, line in epochs]
    ends = [t for t, _, _ in epochs]
    log(f"[app train] yolo11n {APP_IMGSZ} b{APP_BATCH}, {APP_EPOCHS} epochs on step 8's "
        f"{counts['train']} + {counts['val']} images in a thread: {wall:.1f} s; epoch lines "
        f"at {[round(t, 2) for t in ends]} s, img/s {img_s}; launches {launches} as "
        f"predicted; {card}")
    record["train"] = {"wall_s": wall, "epoch_line_s": ends, "epoch_img_s": img_s,
                       "launches": launches, "images": counts, "batch": APP_BATCH,
                       "save_dir_files": sorted(p.name for p in save_dir.iterdir())}
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[app] phase 36 in {record['wall_s']:.1f} s")
    return record


# ---------------------------------------------------------------- phases 37-38

# a child process that loads an exported program and runs it on one batch:
# argv = artifact, batch file, output file, device, repository root (or "")
EXPORT_CHILD = """
import json, sys, time
import torch
from torch.export.passes import move_to_device_pass
artifact, batch_file, out_file, device, repo = sys.argv[1:6]
counts = None
if repo:  # a kernels artifact: register the custom ops, import no model class
    sys.path.insert(0, repo)
    from deal_yolo_daya_tpu_torch.ops.kernels import register_ops
    register_ops()
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa, nms_suppress as ns
t0 = time.perf_counter()
fn = move_to_device_pass(torch.export.load(artifact), device).module()
load_s = time.perf_counter() - t0
x = torch.load(batch_file).to(device)
if repo:
    aa.launches = ns.launches = 0
out = fn(x, torch.tensor(0.001, device=device), torch.tensor(0.7, device=device))
torch.save([t.cpu() for t in out], out_file)
if repo:
    counts = [aa.launches, ns.launches]
print(json.dumps({"modules": sorted(m for m in sys.modules if m.startswith("deal_yolo")),
                  "launches": counts, "load_s": load_s}))
"""


def run_export_children(jobs, batch, out_dir: Path, device):
    """Run each (artifact, repository root or "") of ``jobs`` on ``batch`` in
    a fresh process of its own (EXPORT_CHILD), all at once -> [(its outputs
    on the CPU, its report)]."""
    import torch

    batch_file = out_dir / "batch.pt"
    torch.save(batch.cpu(), batch_file)
    t0 = time.perf_counter()
    procs = []
    for i, (artifact, repo) in enumerate(jobs):
        out_file = out_dir / f"child{i}_out.pt"
        procs.append((artifact, out_file, subprocess.Popen(
            [sys.executable, "-c", EXPORT_CHILD, str(artifact), str(batch_file), str(out_file),
             str(device), repo], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=out_dir)))
    results = []
    for artifact, out_file, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"the child running {artifact} failed:\n{stderr[-3000:]}")
        report = json.loads(stdout.strip().splitlines()[-1])
        report["wall_s"] = time.perf_counter() - t0
        results.append((torch.load(out_file), report))
    return results


def capture_program(module, args):
    """One CUDA graph of ``module(*args)`` (after 3 runs on a side stream),
    its kernel launches recorded by ``GraphLaunches`` -> (replay, outputs):
    ``replay()`` replays it and adds its launches to the counters; the
    static ``outputs`` hold each replay's result."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels._build import GraphLaunches

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            module(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, recorded = torch.cuda.CUDAGraph(), GraphLaunches()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"), recorded.capture():
        outputs = module(*args)

    def replay():
        graph.replay()
        recorded.replayed()

    return replay, outputs


def export_phase(yolo, yolo12, batch, nms_inputs, nms_times, root: Path, card: str):
    """Phase 37: ``export_stablehlo``/``load_stablehlo`` on the card, yolo11n
    (phase 5's handle, class biases 0) at 640 in bf16 on phase 5's first 32
    canvases: (a) the portable artifact (symbolic batch, traced on the CPU)
    and the kernels artifact (``batch_size`` 32, ``use_pallas=True``)
    written, each run in a fresh process (the portable one with nothing of
    either package imported, the kernels one with ``ops.kernels`` and no
    model class) and equal there to the loaded artifact here; (b) the
    kernels artifact bit for bit as ``ServeProgram`` run eagerly (the same
    kernels), the portable one on the card bit for bit as the eager program
    with the plain attention and suppression, and the two against each other
    (largest difference, images whose NMS order flips); (c) conf x iou
    swept through the loaded kernels artifact, each as the eager program at
    it, the detections falling as conf rises; one CUDA graph of its module
    replayed with iou refilled in the input tensor, each replay as eager at
    its iou; (d) the launches of a b32 call (kernels: 1 + 1; portable: 0 +
    0); (e) CUDA-event ms of a b32 call of both loaded artifacts, the eager
    program and ``YOLO.infer``; (f) yolo12n's kernels artifact at b8 (8
    attention launches a call) bit for bit as its eager program; (g) the NMS
    kernel with the threshold as a 0-dim tensor in device memory, bit for bit
    against plain at phase 5's (32, 1000) inputs and phase 4's K = 4096,
    iou 0.45 and 0.7, beside phase 6's times, which now read the threshold
    there as well."""
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.api import ServeProgram, YOLO
    from deal_yolo_daya_tpu_torch.models import blocks
    from deal_yolo_daya_tpu_torch.models.yolo11 import fuse_conv_bn
    from deal_yolo_daya_tpu_torch.ops import nms as nms_ops
    from deal_yolo_daya_tpu_torch.ops.decode import decode_predictions
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns

    t_phase = time.perf_counter()
    dev = batch.device
    out_dir = root / "export"
    out_dir.mkdir(parents=True, exist_ok=True)
    record = {"card": card}
    f32 = dict(dtype=torch.float32, device=dev)

    def eager_program(handle, max_det=300):
        net = fuse_conv_bn(handle._ensure_built()).to(dtype=handle.dtype).eval()
        return ServeProgram(net.requires_grad_(False), handle.imgsz, handle.dtype, max_det)

    def plain_kernels():
        stack = contextlib.ExitStack()
        stack.enter_context(patched(blocks, "area_attention", aa.area_attention_plain))
        stack.enter_context(patched(nms_ops, "nms_suppress", ns.nms_suppress_plain))
        return stack

    def counted(fn):
        aa.launches = ns.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, (aa.launches, ns.launches)

    # (a) both artifacts written and loaded, each run in a fresh process
    t0 = time.perf_counter()
    portable_dir = yolo.export_stablehlo(out_dir / "portable")
    portable_export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels_dir = yolo.export_stablehlo(out_dir / "kernels", batch_size=EXPORT_BATCH,
                                        use_pallas=True)
    kernels_export_s = time.perf_counter() - t0
    fp, meta_p = YOLO.load_stablehlo(portable_dir, device=dev)
    fk, meta_k = YOLO.load_stablehlo(kernels_dir, device=dev)
    check(meta_p["platforms"] == ["cpu", "cuda"] and meta_p["batch_size"] is None
          and meta_k["platforms"] == ["cuda"] and meta_k["batch_size"] == EXPORT_BATCH,
          f"export meta: {meta_p}, {meta_k}")
    graph_ops = {name: sorted({str(n.target) for n in torch.export.load(
        str(d / "model.pt2")).graph.nodes if n.op == "call_function" and "aten" not in
        str(n.target)}) for name, d in (("portable", portable_dir), ("kernels", kernels_dir))}
    check("dyd.area_attention_fwd.default" in graph_ops["kernels"]
          and "dyd.nms_suppress.default" in graph_ops["kernels"]
          and not any("dyd" in op for op in graph_ops["portable"]),
          f"the artifacts' non-aten ops: {graph_ops}")
    conf, iou = torch.tensor(0.001, **f32), torch.tensor(0.7, **f32)
    x = batch[:EXPORT_BATCH]
    out_k, launches_k = counted(lambda: fk(x, conf, iou))
    out_p, launches_p = counted(lambda: fp(x, conf, iou))
    children = {}
    repo = str(Path(__file__).resolve().parent)
    ran = run_export_children([(portable_dir / "model.pt2", ""), (kernels_dir / "model.pt2", repo)],
                              x, out_dir, dev)
    for name, out, (got, report) in zip(("portable", "kernels"), (out_p, out_k), ran):
        same = all(same_bits(g, w.cpu()) for g, w in zip(got, out))
        children[name] = {**report, "equal_to_parent": same}
        log(f"[export] {name} artifact in a fresh process: load {report['load_s']:.2f} s, "
            f"{report['wall_s']:.1f} s in all, launches {report['launches']}, modules of the "
            f"repository imported {report['modules']}; outputs bit for bit as here {same}")
        check(same, f"the {name} artifact's child differs from this process")
    check(children["portable"]["modules"] == [], "the portable child imported the repository")
    check(not any(m.startswith(("deal_yolo_daya_tpu_torch.models", "deal_yolo_daya_tpu_torch.api"))
                  or m == "deal_yolo_daya_tpu" or m.startswith("deal_yolo_daya_tpu.")
                  for m in children["kernels"]["modules"]),
          f"the kernels child imported {children['kernels']['modules']}")
    check(children["kernels"]["launches"] == [1, 1], "the kernels child's launches")

    # (b) each artifact against the eager program it was exported from
    program = eager_program(yolo)
    with torch.no_grad():
        eager_k, launches_e = counted(lambda: program(x, conf, iou))
        with plain_kernels():
            eager_p = program(x, conf, iou)
            xb = (x.permute(0, 3, 1, 2).to(torch.bfloat16) / 255).to(program.compute_dtype)
            pb, ps = decode_predictions(*program.net(xb), (yolo.imgsz, yolo.imgsz))
        kb, ks = decode_predictions(*program.net(xb), (yolo.imgsz, yolo.imgsz))
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(out_k, eager_k)),
          "the kernels artifact differs from the eager program")
    check(all(same_bits(a, b) for a, b in zip(out_p, eager_p)),
          "the portable artifact on the card differs from the eager program with the plain "
          "attention and suppression")
    # the two attentions' outputs differ by bf16 steps (ATTN_TOL), so the
    # decoded boxes and scores differ a little, and greedy NMS keeps other
    # boxes wherever two overlapping candidates swap order
    flips = nms_order_flips(kb.float(), ks.float(), ps.float(), 0.001, 0.7)
    slots = (out_k[0] == out_p[0]).all(-1) & (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
    record["kernels_vs_portable"] = {
        "images": int(x.shape[0]), "images_equal_n_det": int((out_k[3] == out_p[3]).sum()),
        "max_n_det_diff": int((out_k[3] - out_p[3]).abs().max()),
        "identical_output_slots_share": float(slots.float().mean()),
        "pre_nms_max_box_diff_px": (kb.float() - pb.float()).abs().max().item(),
        "pre_nms_max_score_diff": (ks.float() - ps.float()).abs().max().item(),
        "images_with_nms_order_flips": int(sum(flips))}
    vs = record["kernels_vs_portable"]
    log(f"[export] kernels artifact == eager program (kernels) bit for bit; portable artifact "
        f"on the card == eager program (plain attention and suppression) bit for bit; kernels "
        f"vs portable: before NMS boxes {vs['pre_nms_max_box_diff_px']:.3e} px and scores "
        f"{vs['pre_nms_max_score_diff']:.3e} apart, NMS order flips in "
        f"{vs['images_with_nms_order_flips']} of {vs['images']} images; after it n_det equal "
        f"in {vs['images_equal_n_det']} (at most {vs['max_n_det_diff']} apart), "
        f"{100 * vs['identical_output_slots_share']:.1f}% of the output slots identical")

    # (c) conf x iou through one loaded artifact; a CUDA graph of it
    # replayed at two thresholds held in the input tensor
    sweep = {}
    for iou_v in EXPORT_IOUS:
        counts = []
        for conf_v in EXPORT_CONFS:
            ct, it = torch.tensor(conf_v, **f32), torch.tensor(iou_v, **f32)
            got = fk(x, ct, it)
            with torch.no_grad():
                want = program(x, ct, it)
            check(all(same_bits(a, b) for a, b in zip(got, want)),
                  f"the kernels artifact at conf {conf_v} iou {iou_v} differs from eager")
            counts.append(int(got[3].sum()))
        check(all(a >= b for a, b in zip(counts, counts[1:])),
              f"detections do not fall as conf rises at iou {iou_v}: {counts}")
        sweep[str(iou_v)] = dict(zip(map(str, EXPORT_CONFS), counts))
    conf_s, iou_s = torch.tensor(0.001, **f32), torch.tensor(0.7, **f32)
    replay, static = capture_program(fk.module, (x, conf_s, iou_s))
    replays = {}
    for iou_v in EXPORT_IOUS:
        iou_s.fill_(iou_v)
        _, moved = counted(replay)
        with torch.no_grad():
            want = program(x, conf_s, torch.tensor(iou_v, **f32))
        same = all(same_bits(a, b) for a, b in zip(static, want))
        replays[str(iou_v)] = {"n_det": int(static[3].sum()), "equal_to_eager": same,
                               "launches": list(moved)}
        check(same, f"the graph replayed at iou {iou_v} differs from eager at it")
        check(moved == (1, 1), f"a replay launched {moved}")
    n_at = [replays[str(v)]["n_det"] for v in EXPORT_IOUS]
    check(n_at[0] != n_at[1], f"the replays at iou {EXPORT_IOUS} kept as many boxes: the "
          "threshold did not reach the kernel")
    record.update(sweep_n_det=sweep, graph_replays=replays)
    log(f"[export] conf x iou through one artifact, n_det summed over {x.shape[0]} images: "
        f"{sweep}; one CUDA graph replayed at iou {EXPORT_IOUS}: {replays}")

    # (d) launches of a b32 call
    check(launches_k == (1, 1) and launches_p == (0, 0) and launches_e == (1, 1),
          f"launches a b32 call: kernels {launches_k}, portable {launches_p}, eager "
          f"{launches_e}")
    record["launches_b32"] = {"kernels": list(launches_k), "portable": list(launches_p),
                              "eager": list(launches_e)}

    # (e) ms of a b32 call, CUDA events around the call, host included
    with torch.no_grad():
        times = {"kernels artifact": cuda_time_ms(lambda: fk(x, conf, iou), 20),
                 "portable artifact": cuda_time_ms(lambda: fp(x, conf, iou), 5),
                 "eager program": cuda_time_ms(lambda: program(x, conf, iou), 20),
                 "YOLO.infer": cuda_time_ms(lambda: yolo.infer(x, conf=0.001), 20),
                 "kernels artifact graph replay": cuda_time_ms(replay, 20)}
        # the device's busy ms in one call under the profiler (every kernel's
        # self time, summed)
        busy = {name: sum(ms for _, _, ms in profile_rows(fn)[0]) for name, fn in (
            ("kernels artifact", lambda: fk(x, conf, iou)),
            ("portable artifact", lambda: fp(x, conf, iou)),
            ("YOLO.infer", lambda: yolo.infer(x, conf=0.001)))}
    record.update(ms_b32=times, device_busy_ms_b32=busy,
                  export_s={"portable": portable_export_s, "kernels": kernels_export_s},
                  children=children, non_aten_ops=graph_ops)
    log(f"[export] {card}: a b{x.shape[0]} call at {yolo.imgsz} {yolo.dtype}, ms (CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + "; device busy ms in one profiled call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in busy.items())
        + f"; export {portable_export_s:.1f} s portable, {kernels_export_s:.1f} s kernels")

    # (f) yolo12n's kernels artifact at b8
    x8 = batch[:EXPORT12_BATCH]
    d12 = yolo12.export_stablehlo(out_dir / "kernels12", batch_size=EXPORT12_BATCH,
                                  use_pallas=True)
    f12, _ = YOLO.load_stablehlo(d12, device=dev)
    got12, launches12 = counted(lambda: f12(x8, conf, iou))
    with torch.no_grad():
        want12 = eager_program(yolo12)(x8, conf, iou)
    same12 = all(same_bits(a, b) for a, b in zip(got12, want12))
    log(f"[export] yolo12n kernels artifact b{EXPORT12_BATCH}: launches {launches12}, n_det "
        f"{got12[3].tolist()}, bit for bit as its eager program {same12}")
    check(launches12 == (8, 1) and same12, "the yolo12n kernels artifact")
    record["yolo12n_b8"] = {"launches": list(launches12), "equal_to_eager": same12,
                            "n_det_sum": int(got12[3].sum())}

    # (g) the NMS kernel with the threshold in device memory
    parity = {}
    for label, (boxes, valid) in nms_inputs.items():
        for thr in (0.45, 0.7):
            t = torch.tensor(thr, **f32)
            keep = ns.nms_suppress(boxes, valid, t)
            ref = ns.nms_suppress_plain(boxes, valid, t)
            torch.cuda.synchronize()
            bad = int((keep != ref).sum())
            parity[f"{label} iou {thr}"] = bad
            check(bad == 0, f"nms {label} with a device threshold differs in {bad} places")
    record["nms_device_threshold"] = {"mismatched_bits": parity, "times": nms_times}
    log(f"[export] nms_suppress with the threshold a 0-dim tensor on the card, bits off plain: "
        f"{parity}; times (phase 6, the same threshold tensors): "
        + ", ".join(f"{k} device {v['device_ms']:.4f} ms, a call {v['ms']:.4f} ms"
                    for k, v in nms_times.items()))
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[export] phase 37 in {record['wall_s']:.1f} s")
    return record


def write_video(path: Path, images, frames: int, size, fps: float):
    """``frames`` frames of ``size`` (w, h) from ``images`` in turn, mp4v."""
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    check(writer.isOpened(), f"cv2 cannot write {path}")
    for i in range(frames):
        writer.write(cv2.cvtColor(cv2.resize(images[i % len(images)], size), cv2.COLOR_RGB2BGR))
    writer.release()


def sources_phase(yolo, images, root: Path, card: str):
    """Phase 38: predict's other sources on the card, yolo11n at 640 bf16
    (phase 5's handle). A VIDEO_FRAMES-frame VIDEO_SIZE mp4v video of phase
    5's images, ``predict(video, stream=True, save=True, batch_size=16)``:
    every frame's detections bit for bit as ``predict`` on the same decoded
    frames as arrays, the saved ``_pred.mp4`` reopening with every frame,
    frames/s with and without ``save``; an http URL served by a local
    ``http.server`` in a thread (no network), downloaded once and the second
    call a cache hit, bit for bit as the file itself; ``runs/predict``
    auto-incremented in a scratch working directory."""
    import functools
    import http.server
    import threading
    import types

    import cv2
    import numpy as np

    from deal_yolo_daya_tpu_torch.ops.png import write_png

    t_phase = time.perf_counter()
    work = root / "sources"
    work.mkdir(parents=True, exist_ok=True)
    record = {"card": card}
    video = work / "clip.mp4"
    write_video(video, images, VIDEO_FRAMES, VIDEO_SIZE, VIDEO_FPS)

    # the video, streamed and saved, against its frames as arrays
    t0 = time.perf_counter()
    gen = yolo.predict(video, conf=0.001, batch_size=VIDEO_BATCH, stream=True, save=True,
                       save_dir=work / "pred")
    check(isinstance(gen, types.GeneratorType), "predict(stream=True) is not a generator")
    streamed = list(gen)
    saved_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = yolo.predict(video, conf=0.001, batch_size=VIDEO_BATCH)
    unsaved_s = time.perf_counter() - t0
    cap = cv2.VideoCapture(str(video))
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    check(len(streamed) == len(frames) == VIDEO_FRAMES,
          f"{len(streamed)} detections, {len(frames)} decoded frames of {VIDEO_FRAMES}")
    check([d.path for d in streamed] == [f"{video}#frame{i}" for i in range(VIDEO_FRAMES)],
          "the frames' labels")
    same_detections(streamed, yolo.predict(frames, conf=0.001, batch_size=VIDEO_BATCH),
                    "video frames vs the same frames as arrays")
    same_detections(plain, streamed, "predict(video) vs predict(video, stream, save)")
    out = work / "pred" / "clip_pred.mp4"
    cap = cv2.VideoCapture(str(out))
    n_out = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) if cap.isOpened() else -1
    fps_out = cap.get(cv2.CAP_PROP_FPS) if cap.isOpened() else -1.0
    cap.release()
    check(all(d.save_path == out for d in streamed) and n_out == VIDEO_FRAMES,
          f"the saved video {out}: {n_out} frames")
    record["video"] = {
        "frames": VIDEO_FRAMES, "size": list(VIDEO_SIZE), "batch_size": VIDEO_BATCH,
        "frames_per_s_saved": VIDEO_FRAMES / saved_s, "frames_per_s": VIDEO_FRAMES / unsaved_s,
        "saved_frames": n_out, "saved_fps": fps_out,
        "n_det_mean": float(np.mean([len(d) for d in streamed]))}
    log(f"[sources] {card}: video {VIDEO_FRAMES} frames {VIDEO_SIZE[0]}x{VIDEO_SIZE[1]} at "
        f"b{VIDEO_BATCH}: {VIDEO_FRAMES / unsaved_s:.1f} frames/s, "
        f"{VIDEO_FRAMES / saved_s:.1f} frames/s streamed with save (annotate and encode); "
        f"every frame bit for bit as the decoded frames as arrays; {out.name} reopens with "
        f"{n_out} frames at {fps_out:.1f} fps")

    # an http URL from a local server in a thread
    served = work / "served"
    served.mkdir(exist_ok=True)
    name = f"remote_{int(time.time() * 1e6)}.png"  # a name no earlier call cached
    write_png(served / name, images[0])
    hits = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            hits.append(self.path)

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Handler, directory=str(served)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/{name}"
        first = yolo.predict(url, conf=0.001)
        second = yolo.predict([url, images[1]], conf=0.001)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    same_detections(first, yolo.predict(served / name, conf=0.001), "the URL vs the file")
    same_detections(second[:1], first, "the URL's cache hit")
    check(len(hits) == 1 and len(second) == 2 and not thread.is_alive(),
          f"the URL was fetched {len(hits)} times")
    record["url"] = {"requests": len(hits), "cached_path": str(first[0].path)}

    # runs/predict, runs/predict2, ... in a scratch working directory
    with contextlib.chdir(work):
        dirs = [yolo.predict([images[2]], conf=0.001, save=True)[0].save_path.parent.name
                for _ in range(3)]
    check(dirs == ["predict", "predict2", "predict3"], f"save_dir auto-increment: {dirs}")
    record["save_dirs"] = dirs
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[sources] URL fetched {len(hits)} time for two calls, detections as the file's; "
        f"save dirs {dirs}; phase 38 in {record['wall_s']:.1f} s")
    return record


# ---------------------------------------------------------------- phase 39


def tp_gloo_rank(dp, cfg, state_dict, raw, seeds, aug, tf32: bool = True, whole: bool = True):
    """Phase 39, one of the two gloo ranks of a 1 x 2 mesh on the card:
    ``len(seeds)`` eager steps of ``dp_steps`` with the convs of
    TP_MIN_CHANNELS and more sharded over the model group (``aug`` None: a
    ready batch), the attention kernels' inputs recorded and their launches
    counted from 0; every recorded call then held to the plain version ->
    this rank's record: the loss parts, a SHA-256 of its replicated
    parameters' bytes and, with ``whole``, the replicated parameters, BN
    statistics and gathered sharded weights, else (rank 0) the first step's
    gathered gradients."""
    import hashlib

    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.parallel.dryrun import dp_steps

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    rec = {"fwd": [], "bwd": []}

    def rec_fwd(qkv, *a):
        rec["fwd"].append((qkv.clone(), a))
        return orig_fwd(qkv, *a)

    def rec_bwd(qkv, d_out, d_v, *a):
        rec["bwd"].append((qkv.clone(), d_out.clone(), d_v.clone(), a))
        return orig_bwd(qkv, d_out, d_v, *a)

    t0 = time.perf_counter()
    with patched(aa, "area_attention_fwd", rec_fwd) as orig_fwd, \
            patched(aa, "area_attention_bwd", rec_bwd) as orig_bwd:
        aa.launches = aa.bwd_launches = 0
        out = dp_steps(dp, cfg, 80, state_dict, raw, seeds, aug, min_channels=TP_MIN_CHANNELS)
        torch.cuda.synchronize()
        counts = (aa.launches, aa.bwd_launches)
    steps_s = time.perf_counter() - t0
    fwd_err = max(attention_parity(f"tp rank {dp.global_rank} call {i}", q, a)
                  for i, (q, a) in enumerate(rec["fwd"]))
    bwd_err = max(backward_parity(f"tp rank {dp.global_rank} call {i}", q, do, dv, a)
                  for i, (q, do, dv, a) in enumerate(rec["bwd"]))
    log(f"[tp gloo] rank {dp.global_rank} (model rank {dp.mp.rank} of {dp.mp.world}) on "
        f"{dp.device}: {len(seeds)} steps in {steps_s:.1f} s, {len(out['sharded'])} convs "
        f"sharded, attention launches (forward, backward) {counts}, qkv "
        f"{tuple(rec['fwd'][0][0].shape)}, kernel vs plain max |err| forward {fwd_err:.3e} "
        f"backward {bwd_err:.3e}")
    digest = hashlib.sha256()
    for name in sorted(out["replicated"]):
        digest.update(np.ascontiguousarray(out["replicated"][name]).tobytes())
    record = {"rank": dp.global_rank, "launches": counts, "steps_s": steps_s,
              "sharded": out["sharded"], "loss": out["loss"], "replicated_sha": digest.hexdigest(),
              "qkv_shape": list(rec["fwd"][0][0].shape), "fwd_err": fwd_err, "bwd_err": bwd_err}
    if whole:
        record.update(replicated=out["replicated"],
                      stats={k: v for k, v in out["state"].items() if "running_" in k},
                      sharded_state={k: out["state"][k] for k in out["sharded"]})
    elif dp.global_rank == 0:
        record["grads"] = out["grads"]
    return record


def tp_phase(seed: int, data_yaml: Path, root: Path, card: str, cfg_cls):
    """Phase 39: tensor parallelism over a model axis of 2 on the one card
    (see the module docstring) -> (its record, the 1 x 2 Trainer, its
    config, its run directory)."""
    import io

    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.models.yolo11 import YOLO11, init_weights
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.parallel import launch
    from deal_yolo_daya_tpu_torch.parallel.dryrun import dp_steps
    from deal_yolo_daya_tpu_torch.parallel.mesh import create_mesh, local_devices
    from deal_yolo_daya_tpu_torch.parallel.sharding import tp_param_shardings
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.artifacts import MATPLOTLIB_FILES
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig, step_seed
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    imgsz, batch = 640, TP_BATCH
    record = {"card": card, "min_channels": TP_MIN_CHANNELS}

    # 39.1 two gloo ranks of a 1 x 2 mesh on the card against one process,
    # TP_STEPS bf16 steps of yolo11n at b16 from one state
    cfg = TrainConfig(model="yolo11n", imgsz=imgsz, amp=True, seed=seed,
                      max_boxes=GRAPH_MAX_BOXES)
    start = TrainState(cfg, nc=80, steps_per_epoch=100, device=dev)
    want_sharded = sorted(tp_param_shardings(start.model, 2, TP_MIN_CHANNELS))
    sd = {n: v.cpu() for n, v in start.state()["model"].items()}
    del start
    images, boxes, classes, mask = make_train_batch(seed + 11, batch, imgsz)
    raw = (images, np.full((batch, 2), imgsz, np.float32), boxes, classes.astype(np.int32), mask)
    seeds = [step_seed(seed, 2, j) for j in range(TP_STEPS)]
    aug = DeviceAugConfig()
    t0 = time.perf_counter()
    one = dp_steps(None, cfg, 80, sd, raw, seeds, aug, device=dev)
    one_s = time.perf_counter() - t0
    # the one-process run's own sensitivity: the stem kernel one bf16 ulp off
    nudged_sd = dict(sd)
    nudged_sd["0.conv.weight"] = sd["0.conv.weight"] * (1 + 2.0 ** -7)
    nudged = dp_steps(None, cfg, 80, nudged_sd, raw, seeds, aug, device=dev)
    t0 = time.perf_counter()
    ranks = launch.run(tp_gloo_rank, 2, [dev, dev], args=(cfg, sd, raw, seeds, aug),
                       backend="gloo", timeout_s=600.0, n_model=2)
    tp_s = time.perf_counter() - t0
    loss_rel = {n: abs(ranks[0]["loss"][n] - one["loss"][n]) / abs(one["loss"][n])
                for n in ("box_loss", "cls_loss", "dfl_loss")}
    stats = [n for n in one["state"] if "running_" in n]
    stat_diff = max(float(np.abs(ranks[0]["stats"][n] - one["state"][n]).max()) for n in stats)
    stat_move = max(float(np.abs(one["state"][n] - sd[n].numpy()).max()) for n in stats)
    w_diff = max(float(np.abs(ranks[0]["sharded_state"][n] - one["state"][n]).max())
                 for n in want_sharded)
    w_move = max(float(np.abs(one["state"][n] - sd[n].numpy()).max()) for n in want_sharded)
    w_nudge = max(float(np.abs(nudged["state"][n] - one["state"][n]).max())
                  for n in want_sharded if n != "0.conv.weight")
    nudge_loss = {n: abs(nudged["loss"][n] - one["loss"][n]) / abs(one["loss"][n])
                  for n in ("box_loss", "cls_loss", "dfl_loss")}
    nudge_stats = max(float(np.abs(nudged["state"][n] - one["state"][n]).max()) for n in stats)
    same_rep = all(np.array_equal(ranks[0]["replicated"][n], ranks[1]["replicated"][n])
                   for n in ranks[0]["replicated"]) \
        and ranks[0]["replicated_sha"] == ranks[1]["replicated_sha"]
    same_stats = all(np.array_equal(ranks[0]["stats"][n], ranks[1]["stats"][n]) for n in stats)
    log(f"[tp gloo] 1 x 2 (two ranks on the card) vs one process, yolo11n b{batch} {imgsz}, "
        f"{TP_STEPS} bf16 steps ({one_s:.1f} s one process, {tp_s:.1f} s the two ranks with the "
        f"spawn): {len(ranks[0]['sharded'])} convs sharded (tp_param_shardings: "
        f"{len(want_sharded)}); loss parts rel diff {loss_rel} (num_fg "
        f"{ranks[0]['loss']['num_fg']} vs {one['loss']['num_fg']}); BN statistics max |diff| "
        f"{stat_diff:.3e} of the largest move {stat_move:.3e}; gathered sharded weights max "
        f"|diff| {w_diff:.3e} of the largest move {w_move:.3e}. The one-process run with the "
        f"stem kernel one bf16 ulp off: loss parts rel diff {nudge_loss}, BN statistics "
        f"{nudge_stats:.3e}, the sharded weights {w_nudge:.3e}. Replicated parameters "
        f"({len(ranks[0]['replicated'])} tensors) bit-identical across the ranks {same_rep}, BN "
        f"statistics {same_stats}; launches per rank {[r['launches'] for r in ranks]}")
    check(all(r["sharded"] == want_sharded for r in ranks),
          f"sharded {ranks[0]['sharded']}, tp_param_shardings {want_sharded}")
    check(max(loss_rel.values()) <= DP_BF16_LOSS_RTOL, f"1 x 2 ranks' loss parts off: {loss_rel}")
    check(stat_diff <= DP_BF16_STATS_TOL * stat_move, "1 x 2 ranks' BN statistics off by "
          f"{stat_diff} of a move {stat_move}")
    check(w_diff <= 2 * w_nudge + DP_BF16_STATS_TOL * w_move, "1 x 2 ranks' gathered sharded "
          f"weights off by {w_diff}: twice the nudge's {w_nudge} plus {DP_BF16_STATS_TOL} of the "
          f"move {w_move}")
    check(all(tuple(r["launches"]) == (TP_STEPS, TP_STEPS) for r in ranks),
          f"per-rank attention launches {[r['launches'] for r in ranks]}, not 1 + 1 a step")
    check(same_rep and same_stats, "the replicated parameters or BN statistics differ between "
          "the ranks of the model group")
    record["gloo_1x2"] = {
        "batch": batch, "steps": TP_STEPS, "sharded": len(want_sharded),
        "loss_rel_diff": loss_rel, "bn_stats_max_abs_diff": stat_diff,
        "bn_stats_max_move": stat_move, "sharded_weights_max_abs_diff": w_diff,
        "sharded_weights_max_move": w_move, "replicated_bit_identical": same_rep,
        "one_bf16_ulp_stem": {"loss_rel_diff": nudge_loss, "bn_stats_max_abs_diff": nudge_stats,
                              "sharded_weights_max_abs_diff": w_nudge},
        "launches_per_rank": {str(r["rank"]): r["launches"] for r in ranks},
        "kernel_vs_plain_per_rank": {str(r["rank"]): {"forward": r["fwd_err"],
                                                      "backward": r["bwd_err"]} for r in ranks},
        "qkv_shape": ranks[0]["qkv_shape"], "one_process_s": one_s, "two_ranks_s": tp_s}
    del ranks, one
    torch.cuda.empty_cache()

    # 39.2 yolo11x, one f32 step (TF32 off) at b2 in 1 x 2 against one
    # process, and against one process with the stem kernel one ulp off
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfgx = TrainConfig(model="yolo11x", imgsz=imgsz, amp=False, seed=seed)
    wx = small_box_head(init_weights(YOLO11(nc=80, scale="x"), seed).state_dict())
    nudged_wx = dict(wx)
    nudged_wx["0.conv.weight"] = wx["0.conv.weight"] * (1 + np.finfo(np.float32).eps)
    bx = small_gt_batch(make_train_batch(seed + 3, TP_X_BATCH, imgsz)[0].copy(), seed + 3)
    t0 = time.perf_counter()
    onex = dp_steps(None, cfgx, 80, wx, bx, [0], device=dev)
    nudgex = dp_steps(None, cfgx, 80, nudged_wx, bx, [0], device=dev)
    one_x_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranksx = launch.run(tp_gloo_rank, 2, [dev, dev],
                        args=(cfgx, wx, bx, [0], None, False, False),
                        backend="gloo", timeout_s=900.0, n_model=2)
    tp_x_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    gx, g1, gn = ranksx[0]["grads"], onex["grads"], nudgex["grads"]
    rel = {n: float(np.abs(gx[n] - g1[n]).max() / max(np.abs(g1[n]).max(), 1e-30)) for n in g1}
    outside = [n for n in g1 if not np.allclose(gx[n], g1[n], rtol=DP_F32_GRAD_TOL[0],
                                                atol=DP_F32_GRAD_TOL[1])]
    nudge_out = [n for n in g1 if not np.allclose(gn[n], g1[n], rtol=DP_F32_GRAD_TOL[0],
                                                  atol=DP_F32_GRAD_TOL[1])]
    worst = max(float(np.abs(gx[n] - g1[n]).max()
                      / (2 * np.abs(gn[n] - g1[n]).max() + DP_F32_GRAD_TOL[1]
                         + DP_F32_GRAD_TOL[0] * np.abs(g1[n]).max())) for n in g1)
    norm = math.sqrt(sum(float(np.square(np.float64(g1[n])).sum()) for n in g1))
    l2 = math.sqrt(sum(float(np.square(np.float64(gx[n]) - g1[n]).sum()) for n in g1)) / norm
    l2_nudge = math.sqrt(sum(float(np.square(np.float64(gn[n]) - g1[n]).sum()) for n in g1)) / norm
    loss_x = max(abs(ranksx[0]["loss"][n] - onex["loss"][n]) / max(abs(onex["loss"][n]), 1e-30)
                 for n in ("box_loss", "cls_loss", "dfl_loss"))
    same_x = ranksx[0]["replicated_sha"] == ranksx[1]["replicated_sha"]
    log(f"[tp gloo] yolo11x b{TP_X_BATCH} {imgsz}, one f32 step (TF32 off), 1 x 2 vs one "
        f"process ({one_x_s:.1f} s one process twice, {tp_x_s:.1f} s the two ranks): "
        f"{len(ranksx[0]['sharded'])} of yolo11x's convs sharded; loss parts max rel "
        f"{loss_x:.3e}; gradients max |diff| / max |grad| {max(rel.values()):.3e} (median "
        f"{float(np.median(list(rel.values()))):.3e}), {len(outside)} of {len(g1)} tensors "
        f"outside rtol {DP_F32_GRAD_TOL[0]} / atol {DP_F32_GRAD_TOL[1]}; the one-process step "
        f"with the stem kernel one ulp off: {len(nudge_out)} outside; the largest move against "
        f"twice the nudge's plus the bar {worst:.3f}; all gradients as one vector: |diff| / |grad| "
        f"{l2:.3e} (bar {TP_F32_GRAD_L2}), the nudge's {l2_nudge:.3e}; replicated parameters "
        f"bit-identical "
        f"across the ranks {same_x}; launches per rank "
        f"{[r['launches'] for r in ranksx]}")
    check(len(ranksx[0]["sharded"]) == 56, f"yolo11x: {len(ranksx[0]['sharded'])} convs sharded")
    check(same_x, "yolo11x: the replicated parameters differ between the ranks")
    check(loss_x <= DP_F32_LOSS_RTOL, f"yolo11x f32 loss parts of 1 x 2 off by {loss_x}")
    check(l2 <= TP_F32_GRAD_L2, f"yolo11x f32 gradients of 1 x 2 off: |diff| / |grad| {l2}")
    check(worst <= 1.0, f"yolo11x f32 gradients of 1 x 2 off: {worst:.3f} of the floor")
    record["yolo11x_f32"] = {
        "batch": TP_X_BATCH, "sharded": len(ranksx[0]["sharded"]), "loss_max_rel": loss_x,
        "grad_max_rel_of_max": max(rel.values()), "grads_outside": len(outside),
        "one_ulp_stem_outside": len(nudge_out), "grad_worst_of_floor": worst,
        "grad_l2_rel": l2, "one_ulp_stem_grad_l2_rel": l2_nudge,
        "replicated_bit_identical": same_x,
        "launches_per_rank": [r["launches"] for r in ranksx], "one_process_s": one_x_s,
        "two_ranks_s": tp_x_s}
    del ranksx, onex, nudgex, gx, g1, gn
    torch.cuda.empty_cache()

    # 39.3 a 1 x 2 Trainer: two places on the one card (gloo), one epoch of
    # TP_TRAINER_STEPS steps on phase 12's data; rank 0 validates and writes
    card0 = local_devices()[0]
    mesh = create_mesh(1, 2, devices=[card0, card0._replace(id=1)])
    tcfg = cfg_cls(model="yolo11n", data=str(data_yaml), imgsz=imgsz, batch=batch, epochs=1,
                   close_mosaic=0, seed=seed, project=str(root / "runs"), name="tp_1x2",
                   fraction=TP_TRAINER_STEPS * batch / TRAINER_IMAGES[0])
    printed = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            printed.write(s)
            return sys.__stdout__.write(s)

        def flush(self):
            sys.__stdout__.flush()

    t0 = time.perf_counter()
    aa.launches = aa.bwd_launches = ns.launches = dk.launches = 0
    with contextlib.redirect_stdout(Tee()):
        trainer = Trainer(tcfg, mesh=mesh)
        sharded = len(trainer.state.tp)
        result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches,
                "nms_suppress": ns.launches, "device_augment": dk.launches}
    save_dir = Path(result["save_dir"])
    n_val = 2 * len(trainer.val_loader)  # the epoch's validation and train()'s last
    want = trainer_launches(trainer, 1, n_val)
    files = sorted(p.name for p in save_dir.iterdir() if p.is_file())
    jpgs = [f"val_batch{i}_{k}.jpg" for i in range(min(3, len(trainer.val_loader)))
            for k in ("pred", "labels")]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    skip = [ln for ln in printed.getvalue().splitlines()
            if ln.startswith("matplotlib is not installed")]
    log(f"[tp trainer] Trainer(mesh 1 x 2 on the card, gloo): {sharded} convs sharded, "
        f"{len(trainer.train_loader)} steps b{batch} and {n_val} val batches on rank 0 in "
        f"{wall:.1f} s; launches on rank 0 {launches} (want {want}); run directory {files}; "
        f"matplotlib installed {has_mpl}, skip lines {skip}")
    check(trainer.mesh.shape == {"data": 1, "model": 2} and sharded == len(want_sharded),
          f"the 1 x 2 Trainer sharded {sharded} convs")
    check(launches == want, f"1 x 2 Trainer launches {launches}, not {want}")
    check(all(j in files for j in jpgs), f"val_batch images missing: {files}")
    if has_mpl:
        check(all(f in files for f in MATPLOTLIB_FILES), f"plots missing: {files}")
    else:
        check(not any(f in files for f in MATPLOTLIB_FILES) and len(skip) == 1
              and all(f in skip[0] for f in MATPLOTLIB_FILES),
              f"without matplotlib: files {files}, skip lines {skip}")
    record["trainer_1x2"] = {"sharded": sharded, "steps": len(trainer.train_loader),
                             "val_batches": n_val, "wall_s": wall, "launches": launches,
                             "files": files, "matplotlib": has_mpl, "skip_line": skip}
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase 39 in {record['wall_s']:.1f} s")
    return record, trainer, tcfg, save_dir


# ---------------------------------------------------------------- phase 40


def plots_matcher_phase(seed: int, data_yaml: Path, root: Path, best_pt: Path, card: str,
                        cfg_cls):
    """Phase 40: validation with ``save_artifacts`` and the native matcher
    (see the module docstring) -> its record."""
    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch import runtime
    from deal_yolo_daya_tpu_torch.train import metrics
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    record = {"card": card}
    check(runtime.get_lib() is not None, "the native library did not build")
    calls = []
    native = runtime.match_predictions_native

    def recorded(*a):
        out = native(*a)
        calls.append((a, out))
        return out

    cfg = cfg_cls(model=str(best_pt), data=str(data_yaml), imgsz=640, batch=TP_BATCH,
                  epochs=1, seed=seed, project=str(root / "runs"), name="phase40", device="0")
    trainer = Trainer(cfg)
    t0 = time.perf_counter()
    with patched(runtime, "match_predictions_native", recorded):
        got, _ = trainer.validate(save_artifacts=True)
    val_s = time.perf_counter() - t0
    check(len(calls) > 0 and all(out is not None for _, out in calls),
          f"the native matcher was taken {len(calls)} times")
    t0 = time.perf_counter()
    with patched(runtime, "match_predictions_native", lambda *a, **k: None):
        loop = [metrics.match_predictions(*a[:4]) for a, _ in calls]
    loop_s = time.perf_counter() - t0
    differ = sum(not np.array_equal(m, out) for m, (_, out) in zip(loop, calls))
    files = sorted(p.name for p in trainer.run.path.iterdir() if p.is_file())
    jpgs = [f"val_batch{i}_{k}.jpg" for i in range(min(3, len(trainer.val_loader)))
            for k in ("pred", "labels")]
    n_pairs = sum(len(a[0]) * len(a[2]) for a, _ in calls)
    log(f"[phase 40] validate(save_artifacts=True) of phase 39's best.pt on "
        f"{len(trainer.val_ds)} val images in {val_s:.2f} s: the native matcher taken on "
        f"{len(calls)} images ({n_pairs} prediction x GT pairs), mAP50 {got['map50']:.4f}; the "
        f"numpy loop on the same inputs in {loop_s:.2f} s: {differ} matrices differ; files "
        f"{files}")
    check(differ == 0, f"the native matcher and the numpy loop differ on {differ} images")
    check(all(j in files for j in jpgs), f"val_batch images missing: {files}")
    record["matcher"] = {"images": len(calls), "pairs": n_pairs, "differ": differ,
                         "validate_s": val_s, "numpy_loop_s": loop_s, "files": files}
    del trainer
    torch.cuda.empty_cache()

    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase 40] in {record['wall_s']:.1f} s")
    return record


K36_SHAPE = (32, 400, 4)  # yolov10m's PSA at b32/640: (chunks, tokens, heads)
K36_GRAPH_REPLAYS = 20
K36_STEP_REPLAYS = 8  # replays of yolov10m's graphed train step
# phase 44: the task-aligned assigner's kernels (csrc/tal_assign.cu) against
# the plain version (task_aligned_assign_plain) at the train cells' shapes
# (B, N, imgsz, nc), top-k 10 and 1: on the inputs that the yolo11n and
# yolov10m step programs handed the assigner in their eager warm-up steps on
# the cells' own traffic (benchmark/lib/traffic.py, two seeds), and on
# tests/test_torch_assign_kernel.py's cases; every output bit-equal. The
# kernel path takes at most TAL_MAX_MS a call; the step graphs launch it
# once (yolo11n) and twice (yolov10m) a replay
TAL_SHAPE = (32, 128, 640, 80)
TAL_CELLS = (("yolo11n", 1), ("yolov10m", 2))
TAL_STEP_REPLAYS = 8
TAL_MAX_MS = 0.3
# phase 45: train-mode BatchNorm + SiLU (csrc/batch_norm_act.cu) against its
# plain version at every BatchNorm shape of the train cells' b32/640 forwards.
# Per output, max |kernel - plain| over max |plain|. Both sides compute in
# f32 and round once to the input's dtype, so a bf16 output lands at most a
# bf16 step (2^-8 of its value) from plain's: 2^-7 of the largest. In f32
# the statistics' sums run in another order (a few f32 ulps of the mean and
# variance, times |x_hat| up to ~6) and the kernels' exp and reciprocal are
# the fast ones: 1e-4. d_weight and d_bias are f32 sums over up to 3.3 M
# values in another order, from the same inputs: 1e-3 of the largest. The
# running statistics after one update: 1e-5 of the largest.
BN_CELLS = ("yolo11n", "yolo12n", "yolov10m")
BN_STEP_CELLS = ("yolo11n", "yolo12n", "yolov10m")
BN_STEP_REPLAYS = 4
BN_TOL = {"bfloat16": {"z": 2 ** -7, "dx": 2 ** -7, "d_weight": 1e-3, "d_bias": 1e-3,
                       "running_mean": 1e-5, "running_var": 1e-5},
          "float32": {"z": 1e-4, "dx": 1e-4, "d_weight": 1e-3, "d_bias": 1e-3,
                      "running_mean": 1e-5, "running_var": 1e-5}}
# shapes off the cells' path: C not a multiple of the 16-byte vector (the
# masked route), and a dz that is a channel slice of a wider tensor
BN_EDGE_SHAPES = ((32, 12, 40, 40), (8, 100, 20, 20), (4, 3, 7, 9))


def k36_attention_checks(seed: int, card: str):
    """Phase 43: the attention kernels' (key_dim, head_dim) = (36, 72) builds
    (yolov10m's PSA) against their plain versions: the forward (ATTN_TOL, v
    exact) and the backward (BWD_TOL) at (32, 400, 576) x 4 heads, at ragged
    token counts and in f32 (TF32 off); one launch each way a call and, in a
    CUDA graph of AreaAttention's forward and backward, 1 + 1 a replay; the
    device times of both (CUDA events over a graph of launches) against
    their bounds, plain and SDPA. Then the main path: yolov10m's graphed
    b32/640 train step (``StepProgram``) over K36_STEP_REPLAYS replays from
    counters set to 0 takes the (36, 72) builds 1 + 1 a replay (every
    attention launch of the step is theirs), the loss mark once and the six
    phase stamps."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels._build import GraphLaunches

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    kd, hd = 36, 72
    ba, n, heads = K36_SHAPE
    width = heads * (2 * kd + hd)
    a = (heads, hd, kd)
    rec = {"shape": [ba, n, width], "heads": heads, "key_dim": kd, "head_dim": hd, "card": card}

    def qkv_of(b, tokens, dtype):
        return torch.randn((b, tokens, width), generator=gen, device=dev).to(dtype)

    def cot(b, tokens, dtype):  # train-path cotangents are ~1e-3
        return (torch.randn((b, tokens, heads * hd), generator=gen, device=dev) * 1e-3).to(dtype)

    # the plain versions are the references: true f32 products (an earlier
    # phase leaves TF32 on), restored after the checks
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for dtype, shapes in ((torch.bfloat16, [(ba, n), (3, 37), (2, 401), (5, 80)]),
                          (torch.float32, [(4, n), (3, 37)])):
        for b, tokens in shapes:
            label = f"k36 ({b}, {tokens})"
            qkv = qkv_of(b, tokens, dtype)
            f0, b0 = aa.launches, aa.bwd_launches
            fwd_err = attention_parity(label, qkv, a)
            bwd_err = backward_parity(label, qkv, cot(b, tokens, dtype), cot(b, tokens, dtype), a)
            check(aa.launches - f0 == 1 and aa.bwd_launches - b0 == 1,
                  f"attention {label}: launches moved {aa.launches - f0} / "
                  f"{aa.bwd_launches - b0}, not 1 / 1")
            if (b, tokens) == (ba, n) and dtype == torch.bfloat16:
                rec["call_launches"] = [aa.launches - f0, aa.bwd_launches - b0]
            errs[f"{str(dtype).split('.')[-1]} {b}x{tokens}"] = {"fwd": fwd_err, "bwd": bwd_err}
    rec["max_abs_err"] = errs

    # AreaAttention's forward and backward captured in a CUDA graph
    qkv = qkv_of(ba, n, torch.bfloat16).requires_grad_(True)
    g_out, g_v = cot(ba, n, torch.bfloat16), cot(ba, n, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            out, v = aa.area_attention(qkv, *a)
            torch.autograd.backward((out, v), (g_out, g_v))
    torch.cuda.current_stream().wait_stream(side)
    graph, counts = torch.cuda.CUDAGraph(), GraphLaunches()
    qkv.grad = None
    with torch.cuda.graph(graph, capture_error_mode="thread_local"), counts.capture():
        out, v = aa.area_attention(qkv, *a)
        torch.autograd.backward((out, v), (g_out, g_v))
    f0, b0 = aa.launches, aa.bwd_launches
    for _ in range(K36_GRAPH_REPLAYS):
        graph.replay()
        counts.replayed()
    torch.cuda.synchronize()
    rec["graph_launches"] = [aa.launches - f0, aa.bwd_launches - b0]
    log(f"[k36] a CUDA graph of forward + backward, {K36_GRAPH_REPLAYS} replays: launches "
        f"{rec['graph_launches']}")
    check(rec["graph_launches"] == [K36_GRAPH_REPLAYS, K36_GRAPH_REPLAYS],
          f"k36 graph launches {rec['graph_launches']}, not 1 + 1 a replay")
    want = aa.area_attention_bwd_plain(qkv.detach(), g_out, g_v, *a)
    atol, rtol = BWD_TOL["bfloat16"]
    err, worst = within_tol(qkv.grad, want, atol * want.float().abs().max().item(), rtol)
    log(f"[k36] the replayed gradient against plain: max_abs_err {err:.3e}, {worst:.3f} of the "
        "tolerance")
    check(worst <= 1.0, f"k36 replayed gradient off by {err}")
    torch.backends.cuda.matmul.allow_tf32 = saved

    # times at the main shape: each kernel's device time from CUDA events
    # around a graph of its launches (the card's profiler drops launches this
    # late in a run, as the s8 conv's: graph_time_ms), a call's with the host
    # from events around calls in a row; plain and SDPA as calls in a row
    x = qkv.detach()
    split = x.view(ba, n, heads, 2 * kd + hd)
    q, k, v = (t.transpose(1, 2) for t in (split[..., :kd], split[..., kd:2 * kd],
                                           split[..., 2 * kd:]))
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    grad_s = g_out.view(ba, n, heads, hd).transpose(1, 2).contiguous()
    cases = {
        "forward": (lambda: aa.area_attention_fwd(x, heads, hd, kd),
                    lambda: aa.area_attention_plain(x, *a),
                    lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                    1, 2 * heads * hd / width, 2.0 * ba * heads * n * n * (kd + hd)),
        "backward": (lambda: aa.area_attention_bwd(x, g_out, g_v, *a),
                     lambda: aa.area_attention_bwd_plain(x, g_out, g_v, *a),
                     lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), grad_s,
                                                 retain_graph=True),
                     2, 2 * heads * hd / width, 2.0 * ba * heads * n * n * (3 * kd + 2 * hd)),
    }
    for which, (kernel, plain, library, reads, extra, flops) in cases.items():
        dev_ms, ms = graph_time_ms(kernel), cuda_time_ms(kernel, 50)
        plain_ms, lib_ms = cuda_time_ms(plain, 10), cuda_time_ms(library, 10)
        nbytes = x.numel() * 2 * (reads + extra)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        rec[which] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": lib_ms, "library_device_ms": None,
                      "device_ms_by_kernel": {}}
        log(f"[time] k36 {which} {tuple(x.shape)}: kernel device {dev_ms:.4f} ms (a graph of "
            f"launches), a call {ms:.4f} ms with the host; plain {plain_ms:.4f} ms; sdpa "
            f"{lib_ms:.4f} ms a call; bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
            f"ops {t_ops:.4f})")
    del x, split, q, k, v, qs, ks, vs, sdpa_out, grad_s, cases, qkv, graph
    torch.cuda.empty_cache()
    rec["step_graph"] = k36_step_graph(seed, card)
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[k36] phase 43 in {rec['wall_s']:.1f} s")
    return rec


def k36_step_graph(seed: int, card: str):
    """Phase 43's main path: yolov10m's b32/640 bf16 step graph. After the
    eager warm-up steps, the capture and a replay, K36_STEP_REPLAYS replays
    from the attention, (36, 72), mark and stamp counters set to 0."""
    import math

    import numpy as np
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import phase_stamp as ps
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig, step_seed
    from deal_yolo_daya_tpu_torch.train.step_graph import WARMUP_RUNS, StepProgram

    dev = torch.device("cuda")
    x32, *gt32 = (torch.from_numpy(a).to(dev) for a in make_train_batch(seed, 32, 640))
    st = TrainState(TrainConfig(model="yolov10m", imgsz=640, amp=True, seed=seed), nc=80,
                    steps_per_epoch=100, device=dev)
    check(type(st.model).__name__ == "YOLOv10" and st.dual,
          f"yolov10m built {type(st.model).__name__}, dual loss {st.dual}")
    cache = (x32, torch.full((32, 2), 640.0, device=dev), gt32[0], gt32[1].int(), gt32[2])
    prog = StepProgram(st, cache, DeviceAugConfig(), 640, GRAPH_MAX_BOXES, 32)
    rng = np.random.default_rng(seed)
    done = [0]

    def run(k):
        loss = prog.run(np.stack([rng.permutation(32) for _ in range(k)]),
                        [step_seed(seed, 0, done[0] + j) for j in range(k)])
        done[0] += k
        return float(loss)

    run(WARMUP_RUNS + 1)  # the eager warm-up steps, the capture and a replay
    torch.cuda.synchronize()
    check(list(prog.graphs) == [True], f"yolov10m step graphs {list(prog.graphs)}")
    n = K36_STEP_REPLAYS
    aa.launches = aa.bwd_launches = aa.k36_launches = aa.k36_bwd_launches = 0
    ps.launches = ps.mark_launches = 0
    loss = run(n)
    torch.cuda.synchronize()
    got = {"attention": aa.launches, "attention_bwd": aa.bwd_launches,
           "k36": aa.k36_launches, "k36_bwd": aa.k36_bwd_launches,
           "mark": ps.mark_launches, "stamps": ps.launches}
    want = {"attention": n, "attention_bwd": n, "k36": n, "k36_bwd": n, "mark": n,
            "stamps": len(ps.STAMPS) * n}
    log(f"[k36] yolov10m b32/640 graphed step, {n} replays: launches {got} (loss {loss:.4f}, "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB, {card})")
    check(got == want, f"yolov10m step graph launches {got}, not {want}")
    check(math.isfinite(loss), f"yolov10m step graph loss {loss}")
    del prog, st, cache, x32, gt32
    torch.cuda.empty_cache()
    return {"replays": n, "launches": got, "loss": loss}


def load_file_module(path: Path, name: str):
    """A module of this checkout by its file path (benchmark/ and tests/
    are no packages of the port)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tal_assign_checks(seed: int, card: str):
    """Phase 44: the task-aligned assigner's kernels (``csrc/tal_assign.cu``,
    through ``task_aligned_assign`` on the card) against the plain version
    (``task_aligned_assign_plain``) at TAL_SHAPE, top-k 10 and 1, every
    output bit for bit: on the inputs the yolo11n and yolov10m b32/640 step
    programs handed the assigner in their eager warm-up steps on each train
    cell's own traffic, and on the CPU test's cases. The step graphs launch
    the assigner TAL_CELLS' count a replay over TAL_STEP_REPLAYS replays from
    0, and one replay's profile shows its kernels' share. Times by CUDA events
    over a graph: the kernel path (at most TAL_MAX_MS), the plain version,
    the bound (the outputs written once, the predicted boxes read once)."""
    import torch

    from deal_yolo_daya_tpu_torch.ops.kernels import tal_assign as tk
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train import loss as tal_loss
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
    from deal_yolo_daya_tpu_torch.train.step_graph import WARMUP_RUNS, StepProgram

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    dev = torch.device("cuda")
    b, n, imgsz, nc = TAL_SHAPE
    traffic = load_file_module(root / "benchmark" / "lib" / "traffic.py", "bench_traffic")
    cases = load_file_module(root / "tests" / "test_torch_assign_kernel.py", "tal_cases")
    rec = {"shape": [b, n, imgsz, nc], "card": card, "steps": {}, "parity": {}}
    calls, where = [], [""]

    def recording(*args):
        if args[0].device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
            calls.append((where[0], tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                          for x in args)))
        return orig(*args)

    # 44.1 the step programs on the cells' traffic
    with patched(tk, "launch", recording) as orig:
        for k, (model, per) in enumerate(TAL_CELLS):
            where[0] = model
            wl = json.loads((root / "benchmark" / "workloads" / f"{model}.train.b32.json")
                            .read_text())
            cache = traffic.device_cache(seed + k, wl["data"], imgsz, wl["max_boxes"], dev)
            warm = WARMUP_RUNS + 1  # the eager warm-up steps, the capture and a replay
            idx, seeds = traffic.train_schedule(seed + k, wl["data"]["images"], b,
                                                warm + TAL_STEP_REPLAYS)
            st = TrainState(TrainConfig(model=model, imgsz=imgsz, batch=b, amp=True, seed=seed,
                                        max_boxes=wl["max_boxes"]), nc, steps_per_epoch=100,
                            device=dev)
            prog = StepProgram(st, cache, DeviceAugConfig(**wl["augment"]), imgsz,
                               wl["max_boxes"], b)
            prog.run(idx[:warm], seeds[:warm])
            torch.cuda.synchronize()
            check(list(prog.graphs) == [True], f"tal {model}: step graphs {list(prog.graphs)}")
            eager = sum(w == model for w, _ in calls)
            tk.launches = 0
            prog.run(idx[warm:], seeds[warm:])
            torch.cuda.synchronize()
            got = tk.launches
            rows, wall = profile_rows(lambda: prog.graphs[True].replay())
            tal_ms = sum(ms for name, _, ms in rows if "tal_" in name)
            busy = sum(ms for _, _, ms in rows)
            rec["steps"][model] = {"replays": TAL_STEP_REPLAYS, "launches": got,
                                   "eager_calls": eager, "replay_tal_ms": tal_ms,
                                   "replay_busy_ms": busy,
                                   "tal_kernels": {name: [cnt, ms] for name, cnt, ms in rows
                                                   if "tal_" in name}}
            log(f"[tal] {model} b{b}/{imgsz} graphed step on its cell's traffic: {got} assigner "
                f"launches in {TAL_STEP_REPLAYS} replays, {eager} eager calls recorded; one "
                f"replay's profile: the assigner's kernels {tal_ms:.4f} ms of {busy:.2f} ms "
                f"busy ({card})")
            check(got == per * TAL_STEP_REPLAYS, f"tal {model}: {got} launches in "
                  f"{TAL_STEP_REPLAYS} replays, not {per} a replay")
            check(eager == per * WARMUP_RUNS, f"tal {model}: {eager} eager assigner calls in "
                  f"{WARMUP_RUNS} warm-up steps")
            del prog, st, cache
            torch.cuda.empty_cache()

    # 44.2 the kernel path against the plain version, bit for bit
    def parity(label, args, topk):
        scores, pd, anc, lab, gt, mask, nc_, _, alpha, beta, eps, grid = args
        before = tk.launches
        got = tal_loss.task_aligned_assign(scores, pd, anc, lab, gt, mask, nc_, topk, alpha,
                                           beta, eps, grid)
        launched = tk.launches - before
        want = tal_loss.task_aligned_assign_plain(scores, pd, anc, lab, gt, mask, nc_, topk,
                                                  alpha, beta, eps)
        torch.cuda.synchronize()
        same = [same_bits(g, w) for g, w in zip(got, want)]
        apart = int((got[1].view(torch.int32) != want[1].view(torch.int32)).sum())
        worst = float((got[1] - want[1]).abs().max())
        fg = int(want[2].sum())
        log(f"[tal] {label}, top-k {topk}: {fg} foreground anchors; fg, index, boxes equal "
            f"{same[2]}, {same[3]}, {same[0]}; target scores {apart} values apart (max "
            f"|diff| {worst:.3e}); launches {launched}")
        check(launched == 1, f"tal {label}: {launched} launches a call")
        check(same[0] and same[2] and same[3], f"tal {label}, top-k {topk}: the assignment "
              "differs from the plain version's")
        check(same[1], f"tal {label}, top-k {topk}: target scores differ in {apart} values")
        rec["parity"][f"{label}, top-k {topk}"] = {"fg": fg, "scores_apart": apart}

    for i, (model, args) in enumerate(calls):
        for topk in (10, 1):
            parity(f"{model} warm-up call {i}", args, topk)
    for j, case in enumerate(cases.CASES):
        *inputs, grid = cases.case_inputs(case, b, n, imgsz, nc, seed + j)
        args = (*(t.to(dev) for t in inputs), nc, 10, 0.5, 6.0, 1e-9, grid)
        for topk in (10, 1):
            parity(f"case {case}", args, topk)
    del args

    # 44.3 times on the first yolo11n call's inputs
    first = calls[0][1]
    scores, pd, anc, lab, gt, mask, nc_, _, alpha, beta, eps, grid = first

    def kernel_path(topk):
        return lambda: tal_loss.task_aligned_assign(scores, pd, anc, lab, gt, mask, nc_, topk,
                                                    alpha, beta, eps, grid)

    def plain(topk):
        return lambda: tal_loss.task_aligned_assign_plain(scores, pd, anc, lab, gt, mask, nc_,
                                                          topk, alpha, beta, eps)

    dev_ms, o2o_ms = graph_time_ms(kernel_path(10)), graph_time_ms(kernel_path(1))
    call_ms = cuda_time_ms(kernel_path(10), 50)
    plain_ms, plain_o2o_ms = graph_time_ms(plain(10), 5, 3), graph_time_ms(plain(1), 5, 3)
    a = scores.shape[1]
    nbytes = b * a * (4 * 4 + 4 * nc + 1 + 8) + b * a * 4 * 4 + a * 2 * 4 + b * n * (4 * 4 + 8 + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec.update(device_ms=dev_ms, device_ms_topk1=o2o_ms, call_ms=call_ms, plain_ms=plain_ms,
               plain_ms_topk1=plain_o2o_ms, bound_ms=bound_ms, bound_bytes=nbytes)
    log(f"[time] tal_assign ({b}, {n}, {a}, {nc}): kernel path device {dev_ms:.4f} ms at top-k "
        f"10, {o2o_ms:.4f} ms at top-k 1 (a graph of calls), a call {call_ms:.4f} ms with the "
        f"host; {dev_ms / bound_ms:.1f} x its bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB); "
        f"plain {plain_ms:.3f} ms at top-k 10, {plain_o2o_ms:.3f} ms at top-k 1 ({card})")
    check(dev_ms <= TAL_MAX_MS and o2o_ms <= TAL_MAX_MS,
          f"tal: the kernel path takes {dev_ms:.4f} / {o2o_ms:.4f} ms, above {TAL_MAX_MS}")
    del calls, first, scores, pd, anc, lab, gt, mask
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[tal] phase 44 in {rec['wall_s']:.1f} s")
    return rec


def bn_inputs(shape, dtype, gen, dz_slice: bool = False):
    """Inputs of one BatchNorm on the card: x (channels_last) with channel
    means of a few standard deviations, weight, bias, running statistics and
    dz (a channel slice of a wider channels_last tensor where ``dz_slice``)."""
    import torch

    n, c, h, w = shape
    dev = torch.device("cuda")
    mu = torch.randn((1, c, 1, 1), generator=gen, device=dev) * 3.0
    sd = torch.rand((1, c, 1, 1), generator=gen, device=dev) * 1.5 + 0.5
    x = (torch.randn(shape, generator=gen, device=dev) * sd + mu).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    weight = torch.rand((c,), generator=gen, device=dev) + 0.5
    bias = torch.randn((c,), generator=gen, device=dev) * 0.5
    rm = torch.randn((c,), generator=gen, device=dev)
    rv = torch.rand((c,), generator=gen, device=dev) + 0.5
    if dz_slice:
        wide = torch.randn((n, c + 16, h, w), generator=gen, device=dev).to(dtype) \
            .contiguous(memory_format=torch.channels_last)
        dz = wide[:, 8:8 + c]
    else:
        dz = torch.randn(shape, generator=gen, device=dev).to(dtype) \
            .contiguous(memory_format=torch.channels_last)
    return x, weight, bias, rm, rv, dz


def bn_act_checks(seed: int, card: str):
    """Phase 45: train-mode BatchNorm + SiLU (``csrc/batch_norm_act.cu``)
    against its plain version at every BatchNorm shape of BN_CELLS' b32/640
    training forwards (recorded from one forward of each model), in bf16 and
    f32, within BN_TOL, and at BN_EDGE_SHAPES; a CUDA graph of forward and
    backward bit-equal to the eager calls; the Function in BN_STEP_CELLS'
    graphed steps (launches a replay, no ATen batch-norm kernel, SiLU kernels
    only where ``F.silu`` runs outside ConvBN); each cell's BatchNorm calls
    timed beside their bound, plain and ATen."""
    import torch
    import torch.nn.functional as F

    from deal_yolo_daya_tpu_torch.models import blocks
    from deal_yolo_daya_tpu_torch.models.registry import build_detector
    from deal_yolo_daya_tpu_torch.ops.kernels import batch_norm_act as bna
    from deal_yolo_daya_tpu_torch.train import TrainConfig, TrainState
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
    from deal_yolo_daya_tpu_torch.train.step_graph import WARMUP_RUNS, StepProgram

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    dev = torch.device("cuda")
    eps, mom = blocks.BN_EPS, blocks.BN_MOMENTUM
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec = {"card": card, "cells": {}, "parity": {}, "graph": {}, "steps": {}, "times": {}}

    # 45.1 the shapes: one b32/640 training forward of each cell's model
    calls = {}
    for model in BN_CELLS:
        seen = []

        def recording(x, *args, _seen=seen):
            _seen.append((tuple(x.shape), bool(args[4])))
            return orig(x, *args)

        net = build_detector(model, device=dev).train().to(memory_format=torch.channels_last)
        images = torch.rand((32, 3, 640, 640), generator=gen, device=dev) \
            .contiguous(memory_format=torch.channels_last)
        with patched(blocks, "batch_norm_act", recording) as orig, torch.no_grad(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            net(images)
        calls[model] = seen
        shapes = sorted({s for s, _ in seen})
        s_bytes = sum(2 * math.prod(s) for s, _ in seen)
        rec["cells"][model] = {"calls": len(seen), "with_silu": sum(a for _, a in seen),
                               "shapes": len(shapes), "channels": [min(s[1] for s in shapes),
                                                                   max(s[1] for s in shapes)],
                               "S_bytes": s_bytes}
        log(f"[bn] {model} b32/640 training forward: {len(seen)} BatchNorm calls "
            f"({sum(a for _, a in seen)} with SiLU), {len(shapes)} shapes, C "
            f"{rec['cells'][model]['channels']}, S {s_bytes / 1e9:.3f} GB in bf16")
        del net, images
    torch.cuda.empty_cache()

    # 45.2 the kernels against the plain version
    def parity(label, shape, dtype, act, dz_slice=False):
        x, w, b, rm, rv, dz = bn_inputs(shape, dtype, gen, dz_slice)
        rm_p, rv_p = rm.clone(), rv.clone()
        before = bna.launches
        z, mean, invstd, xk = bna.forward_kernel(x, w, b, rm, rv, act, True, eps, mom)
        mid = bna.launches
        dx, dw, db = bna.backward_kernel(dz, xk, w, b, mean, invstd, act)
        launched = (mid - before, bna.launches - mid)
        zp, mean_p, invstd_p = bna.forward_plain(x, w, b, rm_p, rv_p, act, True, eps, mom)
        dxp, dwp, dbp = bna.backward_plain(dz, x, w, b, mean_p, invstd_p, act)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        errs = {}
        for key, got, want in (("z", z, zp), ("dx", dx, dxp), ("d_weight", dw, dwp),
                               ("d_bias", db, dbp), ("running_mean", rm, rm_p),
                               ("running_var", rv, rv_p)):
            scale = float(want.float().abs().max())
            errs[key] = float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)
            check(bool(torch.isfinite(got).all()), f"bn {label} {name}: {key} not finite")
        bad = {k: v for k, v in errs.items() if v > BN_TOL[name][k]}
        rec["parity"][f"{label} {name}"] = errs
        check(launched == (2, 2), f"bn {label} {name}: launches {launched}, not (2, 2)")
        check(not bad, f"bn {label} {name} act {act}: {bad} above {BN_TOL[name]}")
        return errs

    worst = {}
    shapes_acts = sorted({sa for seen in calls.values() for sa in seen})
    for shape, act in shapes_acts:
        for dtype in (torch.bfloat16, torch.float32):
            errs = parity(f"{shape} act {act}", shape, dtype, act)
            name = str(dtype).split(".")[-1]
            for k, v in errs.items():
                worst[f"{name} {k}"] = max(worst.get(f"{name} {k}", 0.0), v)
        torch.cuda.empty_cache()
    log(f"[bn] {len(shapes_acts)} (shape, act) of the cells' forwards against plain, bf16 and "
        f"f32, 2 + 2 launches each; worst max|diff|/max|plain|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items())))
    for shape in BN_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for act in (True, False):
                errs = parity(f"edge {shape} act {act}", shape, dtype, act, dz_slice=True)
        log(f"[bn] edge {shape} (C % vector {shape[1] % 8}, dz a channel slice): within BN_TOL")
    rec["worst"] = worst

    # 45.3 a CUDA graph of forward and backward equals the eager calls, bit for bit
    for shape, act in ((max(shapes_acts, key=lambda sa: math.prod(sa[0]))[0], True),
                       ((32, 256, 20, 20), False), (BN_EDGE_SHAPES[0], True)):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b, rm, rv, dz = bn_inputs(shape, dtype, gen)
            r0 = (rm.clone(), rv.clone())

            def both():
                z, mean, invstd, xk = bna.forward_kernel(x, w, b, rm, rv, act, True, eps, mom)
                return (z, *bna.backward_kernel(dz, xk, w, b, mean, invstd, act))

            eager = [t.clone() for t in both()] + [rm.clone(), rv.clone()]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                both()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), _build_capture() as box:
                outs = both()
            counts = box[0]
            same = []
            for _ in range(2):
                rm.copy_(r0[0])
                rv.copy_(r0[1])
                graph.replay()
                torch.cuda.synchronize()
                same.append(all(same_bits(a, e) for a, e in zip([*outs, rm, rv], eager)))
            label = f"{shape} act {act} {str(dtype).split('.')[-1]}"
            rec["graph"][label] = {"bit_equal": same, "launches": counts}
            log(f"[bn] graph of forward + backward {label}: two replays bit-equal to eager "
                f"{same}; {counts} launches captured")
            check(all(same), f"bn graph {label}: a replay differs from the eager calls")
            check(counts == 4, f"bn graph {label}: {counts} launches captured, not 4")
            del graph, outs, x, dz
    torch.cuda.empty_cache()

    # 45.4 the step graphs on the cells' traffic
    traffic = load_file_module(root / "benchmark" / "lib" / "traffic.py", "bench_traffic_bn")
    b, imgsz = 32, 640
    for k, model in enumerate(BN_STEP_CELLS):
        wl = json.loads((root / "benchmark" / "workloads" / f"{model}.train.b32.json").read_text())
        cache = traffic.device_cache(seed + k, wl["data"], imgsz, wl["max_boxes"], dev)
        warm = WARMUP_RUNS + 1
        idx, seeds = traffic.train_schedule(seed + k, wl["data"]["images"], b,
                                            warm + BN_STEP_REPLAYS)
        st = TrainState(TrainConfig(model=model, imgsz=imgsz, batch=b, amp=True, seed=seed,
                                    max_boxes=wl["max_boxes"]), 80, steps_per_epoch=100,
                        device=dev)
        prog = StepProgram(st, cache, DeviceAugConfig(**wl["augment"]), imgsz, wl["max_boxes"], b)
        fn_calls, silu_calls = [0], [0]

        def counting(*args):
            if not torch.cuda.is_current_stream_capturing():
                fn_calls[0] += 1
            return orig_fn(*args)

        def silu_counting(*args, **kw):
            if not torch.cuda.is_current_stream_capturing():
                silu_calls[0] += 1
            return orig_silu(*args, **kw)

        bna.launches = 0
        with patched(blocks, "batch_norm_act", counting) as orig_fn, \
                patched(F, "silu", silu_counting) as orig_silu:
            prog.run(idx[:warm], seeds[:warm])
        torch.cuda.synchronize()
        check(list(prog.graphs) == [True], f"bn {model}: step graphs {list(prog.graphs)}")
        per_step = fn_calls[0] // WARMUP_RUNS  # the eager warm-up steps' calls
        silu_per_step = silu_calls[0] // WARMUP_RUNS
        eager_launches = bna.launches
        bna.launches = 0
        prog.run(idx[warm:], seeds[warm:])
        torch.cuda.synchronize()
        per_replay = bna.launches / BN_STEP_REPLAYS
        rows, _ = profile_rows(lambda: prog.graphs[True].replay())
        aten_bn = [(n, c_) for n, c_, _ in rows if "batch_norm" in n]
        dyd = {n: [c_, ms] for n, c_, ms in rows if "dyd_bn_" in n}
        silu_fwd = sum(c_ for n, c_, _ in rows if "silu_kernel" in n)
        silu_bwd = sum(c_ for n, c_, _ in rows if "silu_backward" in n)
        bn_ms = sum(ms for _, ms in dyd.values())
        busy = sum(ms for _, _, ms in rows)
        rec["steps"][model] = {"function_calls_a_step": per_step, "launches_a_replay": per_replay,
                               "eager_launches_warmup": eager_launches,
                               "aten_batch_norm_kernels": aten_bn, "dyd_bn_kernels": dyd,
                               "silu_calls_outside_convbn": silu_per_step,
                               "silu_kernels": [silu_fwd, silu_bwd], "replay_bn_ms": bn_ms,
                               "replay_busy_ms": busy}
        log(f"[bn] {model} b32 graphed step on its cell's traffic: {per_step} Function calls a "
            f"step, {per_replay:.1f} launches a replay ({per_replay / max(per_step, 1):.2f} a "
            f"call); profiled replay: ATen batch_norm kernels {len(aten_bn)}, dyd_bn_ launches "
            f"{sum(c_ for c_, _ in dyd.values())} taking {bn_ms:.3f} of {busy:.2f} ms busy, SiLU "
            f"kernels {silu_fwd} forward + {silu_bwd} backward for {silu_per_step} F.silu calls "
            f"outside ConvBN ({card})")
        check(per_step > 0 and per_replay <= 4 * per_step,
              f"bn {model}: {per_replay} launches a replay for {per_step} calls")
        check(not aten_bn, f"bn {model}: ATen batch-norm kernels in the step: {aten_bn}")
        check(sum(c_ for c_, _ in dyd.values()) == per_replay,
              f"bn {model}: the profile holds {dyd} for {per_replay} launches")
        check(silu_fwd == silu_per_step, f"bn {model}: {silu_fwd} SiLU kernels in a replay for "
              f"{silu_per_step} F.silu calls outside ConvBN")
        del prog, st, cache
        torch.cuda.empty_cache()

    # 45.5 times: each cell's BatchNorm calls, forward and backward, bf16
    def timed(shape, act):
        x, w, b_, rm, rv, dz = bn_inputs(shape, torch.bfloat16, gen)

        def kernels():
            z, mean, invstd, xk = bna.forward_kernel(x, w, b_, rm, rv, act, True, eps, mom)
            bna.backward_kernel(dz, xk, w, b_, mean, invstd, act)

        def plain():
            z, mean, invstd = bna.forward_plain(x, w, b_, rm, rv, act, True, eps, mom)
            bna.backward_plain(dz, x, w, b_, mean, invstd, act)

        def aten():
            y, mean, invstd = torch.native_batch_norm(x, w, b_, None, None, True, 0.0, eps)
            gy = dz
            if act:
                torch.ops.aten.silu(y)
                gy = torch.ops.aten.silu_backward(dz, y)
            torch.ops.aten.native_batch_norm_backward(gy, x, w, None, None, mean, invstd, True,
                                                      eps, [True, True, True])

        return (graph_time_ms(kernels, 10, 3), graph_time_ms(aten, 10, 3),
                graph_time_ms(plain, 2, 2))

    shape_ms = {}
    for model in BN_CELLS:
        tot = {"kernels": 0.0, "aten": 0.0, "plain": 0.0}
        for shape, act in calls[model]:
            if (shape, act) not in shape_ms:
                shape_ms[(shape, act)] = timed(shape, act)
                torch.cuda.empty_cache()
            for key, ms in zip(tot, shape_ms[(shape, act)]):
                tot[key] += ms
        s_bytes = rec["cells"][model]["S_bytes"]
        bound = 8 * s_bytes / HBM_BYTES_PER_S * 1e3
        # the kernels' split: the cell's calls once, profiled
        inputs = [bn_inputs(s, torch.bfloat16, gen) + (a,) for s, a in calls[model][:40]]

        def run_all(inputs=inputs):
            for x, w, b_, rm, rv, dz, a in inputs:
                z, mean, invstd, xk = bna.forward_kernel(x, w, b_, rm, rv, a, True, eps, mom)
                bna.backward_kernel(dz, xk, w, b_, mean, invstd, a)

        run_all()
        rows, _ = profile_rows(run_all)
        split = {}
        for n, c_, ms in rows:
            for kname in ("dyd_bn_stats", "dyd_bn_apply", "dyd_bn_bwd_reduce", "dyd_bn_bwd_elemt"):
                if kname in n:
                    split[kname] = split.get(kname, 0.0) + ms
        del inputs
        torch.cuda.empty_cache()
        rec["times"][model] = {"kernels_ms": tot["kernels"], "aten_ms": tot["aten"],
                               "plain_ms": tot["plain"], "bound_ms": bound,
                               "x_bound": tot["kernels"] / bound,
                               "split_first_40_calls_ms": split}
        log(f"[time] {model} BatchNorm + SiLU, the {len(calls[model])} calls of a b32 step, "
            f"forward + backward: kernels {tot['kernels']:.3f} ms, {tot['kernels'] / bound:.2f} x "
            f"the bound {bound:.3f} ms (8 S, S {s_bytes / 1e9:.3f} GB); ATen native_batch_norm + "
            f"silu {tot['aten']:.3f} ms; plain {tot['plain']:.3f} ms; the first 40 calls' "
            f"kernels profiled: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" ms ({card})")
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[bn] phase 45 in {rec['wall_s']:.1f} s")
    return rec


@contextlib.contextmanager
def _build_capture():
    """The BatchNorm kernels' launches inside a graph's capture -> a list
    whose one number is their count when the block ends."""
    from deal_yolo_daya_tpu_torch.ops.kernels._build import GraphLaunches

    gl = GraphLaunches()
    box = []
    with gl.capture():
        yield box
    box.append(sum(n for (mod, _), n in gl.counts.items() if mod.endswith("batch_norm_act")))


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

    from deal_yolo_daya_tpu_torch import api
    from deal_yolo_daya_tpu_torch.api import YOLO
    from deal_yolo_daya_tpu_torch.models import blocks
    from deal_yolo_daya_tpu_torch.ops import nms as nms_ops
    from deal_yolo_daya_tpu_torch.ops.decode import decode_predictions, flatten_levels
    from deal_yolo_daya_tpu_torch.ops.kernels import _build
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as dk
    from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as ns
    from deal_yolo_daya_tpu_torch.ops.kernels import score_reduce as sr
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
    # the wgmma kernels keep their accumulators in registers, NMS its chain's
    # 32 row words, score_reduce a row's 16-byte vectors, the augmentation
    # its two samples' row taps, the assigner a thread's top-16 keys and
    # BatchNorm a thread's channels' sums and U rows of loads: no spills
    for name in ("area_attention", "area_attention_bwd", "nms_suppress", "score_reduce",
                 "int8_conv", "device_augment", "tal_assign", "batch_norm_act"):
        if name in logs:
            spills = [ln for ln in logs[name].splitlines() if "spill" in ln]
            check(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in ln
                                       for ln in spills), f"ptxas reports spills in {name}")

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references are true f32
    torch.backends.cudnn.allow_tf32 = False

    def nms_parity(label, boxes, valid, thr) -> int:
        keep = ns.nms_suppress(boxes, valid, thr)
        ref = ns.nms_suppress_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        bad = int((keep != ref).sum())
        log(f"[nms] {label} {tuple(boxes.shape)} iou {thr}: kept {int(keep.sum())} of "
            f"{int(valid.sum())} valid, mismatched bits {bad}")
        check(bad == 0, f"nms {label}: keep mask differs in {bad} places")
        return bad

    def bit_identical(label, kernel, *args) -> None:
        """Two launches of a kernel on the same inputs give the same bits."""
        first, second = ((x if isinstance(x, tuple) else (x,))
                         for x in (kernel(*args), kernel(*args)))
        torch.cuda.synchronize()
        same = all(torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
                   for x, y in zip(first, second))  # bits, so NaN equals NaN
        log(f"[determinism] {label}: two launches bit-identical {same}")
        check(same, f"{label}: two launches differ")

    # 3. attention kernel vs its plain version: yolo11n's C2PSA shape (n=400
    # at imgsz 640), the ragged n=35 and n=1600 (imgsz 1280), f32 and bf16
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for n in (400, 35, 1600):
        for dt in (torch.bfloat16, torch.float32):
            qkv = torch.randn((32, n, 256), generator=gen, device=dev).to(dt)
            attention_parity(f"random n={n}", qkv, (2, 64, 32))

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
    # the launch geometry, and how many of its clusters the card holds at once
    active = ns.active_clusters()
    log(f"[nms] cudaOccupancyMaxActiveClusters by cluster size 1..8: {active[1:]} (the H100 "
        f"SXM table: {ns.ACTIVE_CLUSTERS[1:]})")
    for b_, k_ in ((1, 1000), (3, 1000), (32, 1000), (32, ns.MAX_K)):
        geo = ns.nms_geometry(b_, k_, active)
        log(f"[nms] geometry B={b_} K={k_}: {geo._asdict()}, {b_ * geo.cluster} CTAs; "
            f"cudaOccupancyMaxActiveClusters {ns.max_active_clusters(geo)}")
    # the edge grid: ragged and limit K, one and few images, iou 0 (any
    # overlap suppresses), holes in valid; bit for bit against plain and
    # against itself
    for b_ in NMS_EDGE_B:
        for k_ in NMS_EDGE_K:
            xy = rng.uniform(0, 600, (b_, k_, 2))
            wh = rng.uniform(8, 200, (b_, k_, 2))
            offset = rng.integers(0, 3, (b_, k_, 1)) * 7680.0
            boxes = torch.tensor(np.concatenate([xy, xy + wh], -1) + offset,
                                 dtype=torch.float32, device=dev)
            valid = torch.tensor(rng.random((b_, k_)) > 0.15, device=dev)
            for thr in (0.0, 0.45, 0.7):
                nms_parity("edge grid", boxes, valid, thr)
                bit_identical(f"nms edge grid B={b_} K={k_} iou {thr}", ns.nms_suppress, boxes,
                              valid, thr)
    # K beyond the walking CTA's shared memory: the global-memory mapping,
    # bit for bit against plain and against itself, on dense scenes at B=32
    large_k = {}
    for k_ in NMS_LARGE_K:
        xy = rng.uniform(0, 600, (32, k_, 2))
        wh = rng.uniform(8, 200, (32, k_, 2))
        offset = rng.integers(0, 3, (32, k_, 1)) * 7680.0
        boxes = torch.tensor(np.concatenate([xy, xy + wh], -1) + offset,
                             dtype=torch.float32, device=dev)
        valid = torch.tensor(rng.random((32, k_)) > 0.15, device=dev)
        geo = ns.nms_geometry(32, k_, active)
        check(geo.in_global, f"K={k_} did not take the global-memory mapping: {geo}")
        log(f"[nms] geometry B=32 K={k_}: {geo._asdict()} (bitmask "
            f"{ns.bitmask_words(32, k_) * 4 / 1e6:.1f} MB in device memory)")
        for thr in (0.0, 0.45, 0.7):
            nms_parity("large K", boxes, valid, thr)
            bit_identical(f"nms large K B=32 K={k_} iou {thr}", ns.nms_suppress, boxes, valid, thr)
        large_k[k_] = (boxes, valid)
    # batched_nms with pre_topk 4096 on the card against the CPU path on the
    # same inputs: every output equal
    xy = torch.rand((4, 8400, 2), generator=gen, device=dev) * 600
    wh = 8 + torch.rand((4, 8400, 2), generator=gen, device=dev) * 192
    boxes_a = torch.cat([xy, xy + wh], -1)
    scores_a = torch.rand((4, 8400, 80), generator=gen, device=dev)
    before = ns.launches
    got = nms_ops.batched_nms(boxes_a, scores_a, conf_thres=0.001, iou_thres=0.7, pre_topk=4096)
    torch.cuda.synchronize()
    card_launches = ns.launches - before
    want = nms_ops.batched_nms(boxes_a.cpu(), scores_a.cpu(), conf_thres=0.001, iou_thres=0.7,
                               pre_topk=4096)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    log(f"[nms] batched_nms pre_topk 4096 on {tuple(scores_a.shape)} scores: n_det "
        f"{got[3].tolist()} on the card, {want[3].tolist()} on the CPU, every output equal "
        f"{same}, kernel launches {card_launches}")
    check(same and card_launches == 1, "batched_nms(pre_topk=4096) differs from the CPU")

    # 5. predict, the main path (bf16)
    images = make_images(args.seed, 64)
    yolo = YOLO("yolo11n", nc=80, imgsz=640, seed=args.seed)
    check(yolo.dtype == torch.bfloat16, "predict on the card must default to bf16")
    zero_class_bias(yolo)
    recorded = {"attn": [], "nms": []}
    # the class logits each path hands to decode, (B, A, nc) as flatten_levels
    # makes them: score_reduce's inputs in phase 13
    logits_rec = {"predict": [], "validation": []}

    def logits_recorder(key, decode):
        def run(box, cls, *a, **k):
            logits_rec[key].append(flatten_levels(box, cls)[1].clone())
            return decode(box, cls, *a, **k)
        return run

    def rec_attention(qkv, *a):
        recorded["attn"].append((qkv.clone(), a))
        return orig_attention(qkv, *a)

    def rec_suppress(boxes, valid, thr):
        recorded["nms"].append((boxes.clone(), valid.clone(), thr))
        return orig_suppress(boxes, valid, thr)

    with patched(blocks, "area_attention", rec_attention) as orig_attention, \
            patched(nms_ops, "nms_suppress", rec_suppress) as orig_suppress, \
            patched(api, "decode_predictions",
                    logits_recorder("predict", api.decode_predictions)):
        aa.launches = 0
        ns.launches = 0
        sr.launches = 0
        results = yolo.predict(images, conf=0.001, batch_size=32)
        torch.cuda.synchronize()
        launches = {"area_attention": aa.launches, "nms_suppress": ns.launches,
                    "score_reduce (not on the path)": sr.launches}
    log(f"[predict] {len(results)} images, launches {launches}")
    for name in ("area_attention", "nms_suppress"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
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
    for i, (q, a) in enumerate(recorded["attn"]):
        bit_identical(f"attention main-path call {i}", aa.area_attention_fwd, q, *a)
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

    # 6. times: each kernel's device time a call from torch.profiler, and
    # the time a call costs its caller, host included (CUDA events around 200
    # calls in a row); the same two for the library call
    kernels = []
    qkv, (heads, hd, kd) = recorded["attn"][0]
    ba, n, _ = qkv.shape
    ms, dev_ms, kernel_text, by_kernel = call_and_device_ms(
        lambda: aa.area_attention(qkv, heads, hd, kd), "area_attention")
    plain_ms = cuda_time_ms(lambda: aa.area_attention_plain(qkv, heads, hd, kd), 50)
    split = qkv.view(ba, n, heads, 2 * kd + hd)
    q, k, v = (t.transpose(1, 2) for t in (split[..., :kd], split[..., kd:2 * kd],
                                           split[..., 2 * kd:]))
    library_ms, lib_dev_ms, library_text, _ = call_and_device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), "sdpa")
    nbytes = qkv.numel() * qkv.element_size() * (1 + 2 * heads * hd / qkv.shape[2])
    flops = 2.0 * ba * heads * n * n * (kd + hd)
    peak = BF16_FLOPS if qkv.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    kernels.append({
        "name": "area_attention", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/area_attention.cu",
        "replaces": "deal_yolo_daya_tpu/ops/pallas/area_attention.py:46",
        "launches": launches["area_attention"], "max_abs_err": attn_err_main,
        "tol": ATTN_TOL["bfloat16"], "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "library_device_ms": lib_dev_ms, "shape": list(qkv.shape),
        "dtype": str(qkv.dtype), "device_ms_by_kernel": by_kernel,
    })
    log(f"[time] area_attention {tuple(qkv.shape)} {qkv.dtype}: kernel {kernel_text}; plain "
        f"{plain_ms:.4f} ms; sdpa {library_text}; bound {max(t_bytes, t_ops):.4f} ms (bytes "
        f"{t_bytes:.4f}, ops {t_ops:.4f})")

    boxes, valid, thr = recorded["nms"][0]
    # the threshold in device memory, made once: each timed call is the
    # kernel alone (a float threshold is one fill kernel more a call)
    thr_dev = ns.threshold_tensor(thr, dev)
    ms, dev_ms, kernel_text, by_kernel = call_and_device_ms(
        lambda: ns.nms_suppress(boxes, valid, thr_dev), "nms_suppress")
    # the walking CTAs' SM clocks split the device time: the mask phase (until
    # the bitmask's last row tile is in) and the walk's tail after it; the
    # walk overlaps the mask phase, waiting for each row tile
    stamps = torch.zeros((boxes.shape[0], 3), dtype=torch.int64, device=dev)
    ns.launch(boxes, valid, thr, stamps)
    torch.cuda.synchronize()
    cycles = stamps.double().mean(0).tolist()  # to the last tile, whole kernel, waiting
    total_cycles = max(cycles[1], 1.0)
    nms_phases = {"mask": dev_ms * cycles[0] / total_cycles,
                  "walk_tail": dev_ms * (cycles[1] - cycles[0]) / total_cycles,
                  "walk_waiting_share": cycles[2] / total_cycles}
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
        "tol": 0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "library_device_ms": None, "shape": list(boxes.shape),
        "valid_pairs": pairs, "device_ms_by_kernel": by_kernel, "phase_device_ms": nms_phases,
        "phase_sm_cycles": cycles,
        "geometry": ns.nms_geometry(*valid.shape, ns.active_clusters())._asdict(),
    })
    log(f"[time] nms_suppress {tuple(boxes.shape)}: kernel {kernel_text}; plain {plain_ms:.4f} "
        f"ms; bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.5f}, ops {t_ops:.4f}; "
        f"{pairs:.0f} valid pairs); by SM clock: mask phase {nms_phases['mask']:.4f} ms, walk "
        f"after it {nms_phases['walk_tail']:.4f} ms (mean cycles: to the last row tile "
        f"{cycles[0]:.0f}, whole kernel {cycles[1]:.0f}, the walk waiting {cycles[2]:.0f})")

    # the global-memory mapping at B=32, K=4096 (a dense scene of phase 4)
    big_boxes, big_valid = large_k[NMS_LARGE_K[-1]]
    big_thr = ns.threshold_tensor(0.7, dev)
    big_ms, big_dev_ms, big_text, big_by_kernel = call_and_device_ms(
        lambda: ns.nms_suppress(big_boxes, big_valid, big_thr), "nms_suppress large K")
    big_plain_ms = cuda_time_ms(lambda: ns.nms_suppress_plain(big_boxes, big_valid, 0.7), 3)
    nv = big_valid.sum(1).double()
    big_pairs = float((nv * (nv - 1) / 2).sum())
    t_bytes = (big_boxes.numel() * 4 + big_valid.numel() * 2) / HBM_BYTES_PER_S * 1e3
    t_ops = big_pairs * IOU_OPS / F32_FLOPS * 1e3
    kernels[-1]["large_k"] = {
        "shape": list(big_boxes.shape), "iou": 0.7, "mapping": "global",
        "geometry": ns.nms_geometry(*big_valid.shape, ns.active_clusters())._asdict(),
        "ms": big_ms, "device_ms": big_dev_ms, "plain_ms": big_plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "valid_pairs": big_pairs, "device_ms_by_kernel": big_by_kernel, "mismatched_bits": 0}
    log(f"[time] nms_suppress {tuple(big_boxes.shape)} (global-memory mapping): kernel "
        f"{big_text}; plain {big_plain_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
        f"({big_pairs:.0f} valid pairs)")
    # phase 37 holds the kernel to plain with device thresholds on these inputs
    nms_inputs = {f"{tuple(boxes.shape)} cluster mapping": (boxes, valid),
                  f"{tuple(big_boxes.shape)} global-memory mapping": (big_boxes, big_valid)}
    nms_times = {f"{tuple(boxes.shape)} cluster mapping": {"ms": kernels[1]["ms"],
                                                             "device_ms": kernels[1]["device_ms"]},
                 f"{tuple(big_boxes.shape)} global-memory mapping": {"ms": big_ms,
                                                                       "device_ms": big_dev_ms}}

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
    for i, (q, a) in enumerate(train_rec["fwd"]):
        bit_identical(f"attention train-path call {i}", aa.area_attention_fwd, q, *a)
    for i, (q, do, dv, a) in enumerate(train_rec["bwd"]):
        bit_identical(f"attention bwd train-path call {i}", aa.area_attention_bwd, q, do, dv,
                      *a)

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

    # 10. times: the backward kernel at the train path's inputs (device time
    # from torch.profiler, and a call's time with the host), its plain
    # version, SDPA's backward alone, the bound; then the train step
    qkv_b, do_b, dv_b, (heads, hd, kd) = train_rec["bwd"][0]
    ba, n, _ = qkv_b.shape
    ms, dev_ms, kernel_text, by_kernel = call_and_device_ms(
        lambda: aa.area_attention_bwd(qkv_b, do_b, dv_b, heads, hd, kd), "area_attention_bwd")
    plain_ms = cuda_time_ms(lambda: aa.area_attention_bwd_plain(qkv_b, do_b, dv_b, heads, hd, kd),
                            20)
    split = qkv_b.view(ba, n, heads, 2 * kd + hd)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in (split[..., :kd], split[..., kd:2 * kd], split[..., 2 * kd:]))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    sdpa_grad = do_b.view(ba, n, heads, hd).transpose(1, 2).contiguous()

    def sdpa_backward():
        torch.autograd.grad(sdpa_out, (q, k, v), sdpa_grad, retain_graph=True)

    library_ms, lib_dev_ms, library_text, _ = call_and_device_ms(sdpa_backward, "sdpa backward")
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
        "tol": BWD_TOL["bfloat16"], "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "library_device_ms": lib_dev_ms, "shape": list(qkv_b.shape),
        "dtype": str(qkv_b.dtype), "device_ms_by_kernel": by_kernel,
    })
    log(f"[time] area_attention_bwd {tuple(qkv_b.shape)} {qkv_b.dtype}: kernels {kernel_text}; "
        f"plain {plain_ms:.4f} ms; sdpa backward {library_text}; bound {max(t_bytes, t_ops):.4f} "
        f"ms (bytes {t_bytes:.4f} for {nbytes / 1e6:.2f} MB, ops {t_ops:.4f} for "
        f"{flops / 1e9:.2f} GFLOP)")

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

    # 12. the Trainer, the third main path: yolo11n on a synthetic shapes
    # dataset of mixed-size PNG sources written here, 3 epochs at imgsz 640,
    # batch 32, bf16, the dataset on the card and augmented there, validation
    # after each epoch, results.csv and checkpoints
    import tempfile

    from deal_yolo_daya_tpu_torch.train import metrics as metrics_mod
    from deal_yolo_daya_tpu_torch.train import trainer as trainer_mod
    from deal_yolo_daya_tpu_torch.train.device_augment import step_seed
    from deal_yolo_daya_tpu_torch.train.trainer import (TrainConfig as FullConfig, Trainer,
                                                        inference_state_dict, load_checkpoint)

    del state, train_x, train_gt, grads_k, grads_p
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    data_yaml = write_shapes_dataset(root / "shapes", args.seed)
    write_s = time.perf_counter() - t0
    log(f"[trainer] wrote {TRAINER_IMAGES} PNG sources, {TRAINER_SIDES[0]}-"
        f"{TRAINER_SIDES[1] - 1} px on the long side, in {write_s:.1f} s")
    tcfg = FullConfig(model="yolo11n", data=str(data_yaml), imgsz=640, batch=TRAINER_BATCH,
                      epochs=TRAINER_EPOCHS, close_mosaic=1, cache="device",
                      device_augment=True, amp=True, seed=args.seed, device="0",
                      project=str(root / "runs"), name="smoke", steps_per_dispatch=1)
    trainer = Trainer(tcfg)
    check(trainer.device == dev and trainer.nc == 3, "the Trainer is not on the card")

    # instrumentation: CUDA events around each augment and step, host clocks
    # around validation, the host metrics and the checkpoints; an epoch starts
    # when it asks for its batches and ends at its results.csv row, before its
    # checkpoints
    clocks = {"augment": [], "step": [], "val_s": [], "metric_s": [0.0], "ckpt_s": [0.0],
              "starts": [], "rows": []}

    def cuda_timed(fn, sink):
        def run(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            clocks[sink].append((start, end))
            return out
        return run

    def host_timed(fn, sink, add=False):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if add:
                clocks[sink][-1] += time.perf_counter() - t
            else:
                clocks[sink].append(time.perf_counter() - t)
            return out
        return run

    def row_mark(fn):
        def run(row):
            clocks["rows"].append((time.perf_counter(), len(clocks["augment"]),
                                   len(clocks["val_s"]), clocks["metric_s"][-1],
                                   clocks["ckpt_s"][-1]))
            return fn(row)
        return run

    trainer.augment = cuda_timed(trainer.augment, "augment")
    trainer.state.step = cuda_timed(trainer.state.step, "step")
    trainer.validate = host_timed(trainer.validate, "val_s")
    trainer.save_checkpoint = host_timed(trainer.save_checkpoint, "ckpt_s", add=True)
    trainer.run.append_results_row = row_mark(trainer.run.append_results_row)
    train_epoch = trainer._train_epoch

    def epoch_start(epoch):
        clocks["starts"].append(time.perf_counter())
        return train_epoch(epoch)

    trainer._train_epoch = epoch_start
    recorded["val_nms"] = []

    def rec_val_suppress(boxes, valid, thr):
        recorded["val_nms"].append((boxes.clone(), valid.clone(), thr))
        return orig_val_suppress(boxes, valid, thr)

    with patched(trainer_mod, "decode_predictions",
                 logits_recorder("validation", trainer_mod.decode_predictions)), \
            patched(nms_ops, "nms_suppress", rec_val_suppress) as orig_val_suppress, \
            patched(metrics_mod.DetMetrics, "update",
                    host_timed(metrics_mod.DetMetrics.update, "metric_s", add=True)), \
            patched(metrics_mod.DetMetrics, "compute",
                    host_timed(metrics_mod.DetMetrics.compute, "metric_s", add=True)):
        aa.launches = aa.bwd_launches = ns.launches = sr.launches = dk.launches = 0
        t_train = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t_train
        trainer_launches = {"area_attention": aa.launches,
                            "area_attention_bwd": aa.bwd_launches,
                            "nms_suppress": ns.launches,
                            "score_reduce (not on the path)": sr.launches,
                            "device_augment": dk.launches}
    n_steps = trainer.state.updates
    n_val_batches = len(clocks["val_s"]) * len(trainer.val_loader)
    log(f"[trainer] {TRAINER_EPOCHS} epochs in {train_wall:.1f} s: {n_steps} steps, "
        f"{len(clocks['val_s'])} validations of {len(trainer.val_loader)} batches; launches "
        f"{trainer_launches}")
    check(n_steps == TRAINER_EPOCHS * (TRAINER_IMAGES[0] // TRAINER_BATCH),
          f"the Trainer took {n_steps} steps")
    check(trainer_launches["area_attention"] == n_steps + n_val_batches,
          "attention forward launches != train steps + validation forwards")
    check(trainer_launches["area_attention_bwd"] == n_steps,
          "attention backward launches != train steps")
    check(trainer_launches["nms_suppress"] == n_val_batches, "NMS launches != val batches")
    check(trainer_launches["device_augment"] == n_steps,
          "augmentation kernel launches != train steps")
    # NMS against its plain version on the validation batches' own inputs (nc 3)
    log(f"[trainer] validation NMS inputs: valid candidates per image, min and max over each "
        f"batch {[(int(v.sum(1).min()), int(v.sum(1).max())) for _, v, _ in recorded['val_nms']]}")
    val_mismatched = sum(nms_parity(f"validation call {i}", b, v, t)
                         for i, (b, v, t) in enumerate(recorded["val_nms"]))

    # the run's artifacts
    save_dir = Path(result["save_dir"])
    import csv

    with open(save_dir / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    from deal_yolo_daya_tpu_torch.train.artifacts import RESULTS_COLUMNS

    check(len(rows) == TRAINER_EPOCHS and all(list(r) == RESULTS_COLUMNS for r in rows),
          "results.csv does not hold one row of the 15 columns an epoch")
    loss_cols = [c for c in RESULTS_COLUMNS if c.endswith("_loss")]
    check(all(np.isfinite(float(r[c])) and float(r[c]) >= 0 for r in rows for c in loss_cols),
          "a loss in results.csv is not finite")
    check(all(float(r["train/cls_loss"]) > 0 and float(r["val/cls_loss"]) > 0 for r in rows),
          "a zero class loss")
    for r in rows:
        log(f"[trainer] results.csv epoch {r['epoch']}: " + ", ".join(
            f"{c} {r[c]}" for c in RESULTS_COLUMNS[2:]))
    check((save_dir / "args.yaml").exists(), "no args.yaml")
    live = trainer.state.state()
    last = load_checkpoint(save_dir / "weights" / "last.pt")
    best = load_checkpoint(save_dir / "weights" / "best.pt")
    for part in ("model", "ema"):
        check(all(torch.equal(last[part][k], v) for k, v in live[part].items()),
              f"weights/last.pt {part} does not reload bit for bit")
    check(last["epoch"] == TRAINER_EPOCHS - 1 and last["updates"] == n_steps,
          "weights/last.pt is not the last epoch")
    fits = [trainer_mod.fitness({"map50": float(r["metrics/mAP50(B)"]),
                                 "map": float(r["metrics/mAP50-95(B)"])}) for r in rows]
    check(best["fitness"] == result["best_fitness"] >= last["fitness"]
          and best["fitness"] >= max(fits) - 1e-5, "weights/best.pt is not the best epoch")
    log(f"[trainer] weights {sorted(p.name for p in (save_dir / 'weights').iterdir())}; "
        f"best epoch {best['epoch'] + 1} (fitness {best['fitness']:.6g}); last.pt reloads bit "
        "for bit")

    # YOLO(best.pt) against validation's EMA model on one val batch, both in
    # f32 with TF32 off (fused vs unfused, phase 5's tolerances): the same
    # decoded boxes and scores at every anchor. Then the same detections. After
    # 24 steps the scores still sit near the class prior, tied within f32 noise
    # across neighbouring anchors, so which of two overlapping candidates
    # greedy NMS keeps first is the noise's to decide; the detections are
    # compared with the class biases set to 0 in both (as phase 5 does), with
    # class-agnostic NMS at conf and iou thresholds that no score and no IoU
    # comes near, on the images where every two overlapping candidates come in
    # the same score order in both models, and with the same class wherever
    # the best two class scores lie further apart than twice the largest
    # score difference between the two models
    def best_vs_validation(trainer, save_dir, tcfg, best, label, box_tol=PRED_TOL["boxes_px"]):
        """The check above for a Trainer run: YOLO(best.pt) against its
        validation's EMA model, boxes within ``box_tol`` px. Returns
        YOLO(best.pt)."""
        torch.backends.cudnn.allow_tf32 = False
        trainer.state.load_state(best)
        yolo_best = YOLO(str(save_dir / "weights" / "best.pt"), dtype=torch.float32)
        check(yolo_best.nc == 3 and yolo_best.names == SHAPES and yolo_best.imgsz == tcfg.imgsz,
              "YOLO(best.pt) lost nc, names or imgsz")
        best_sd = inference_state_dict(best)
        check(all(torch.equal(v.cpu(), best_sd[k])
                  for k, v in yolo_best._model.state_dict().items()),
              "YOLO(best.pt) does not hold best.pt's EMA weights")
        val_iter = trainer.val_loader.epoch(0)
        vbatch = next(val_iter)
        val_iter.close()
        vx = torch.from_numpy(vbatch.images).to(dev)
        nb = len(vbatch.images)
        st = trainer.state

        def both_decoded():
            """(validation's EMA model, YOLO(best.pt)) decoded outputs and their
            largest box and score differences."""
            with patched(st, "cfg", dataclasses.replace(st.cfg, amp=False)), \
                    patched(st, "dtype", torch.float32):
                ev = decode_predictions(*st.eval_forward(vx), (640, 640))
            yb = decode_predictions(*yolo_best._fused_model()(vx.permute(0, 3, 1, 2).float()),
                                    (640, 640))
            torch.cuda.synchronize()
            errs = ((yb[0] - ev[0]).abs().max().item(), (yb[1] - ev[1]).abs().max().item())
            check(errs[0] <= box_tol and errs[1] <= PRED_TOL["scores"],
                  f"YOLO(best.pt) decodes boxes {errs[0]} px, scores {errs[1]} off validation's")
            return ev, yb, errs

        _, _, (dec_box_err, dec_score_err) = both_decoded()
        zero_class_bias(yolo_best)
        yolo_best._fused_cache = None
        with torch.no_grad():
            ema = st.ema_state_dict()
            for i in range(3):
                ema[f"{st.model.DETECT}.cv3.{i}.2.bias"].zero_()
        (ev_boxes, ev_scores), (_, yb_scores), (box_err0, score_err0) = both_decoded()
        conf, conf_gap, iou, iou_gap = nms_thresholds(ev_boxes, ev_scores, 10 * nb, 50 * nb)
        want = nms_ops.batched_nms(ev_boxes, ev_scores, conf_thres=conf, iou_thres=iou,
                                   pre_topk=1000, max_det=tcfg.max_det, class_agnostic=True)
        got = yolo_best.infer(vx, conf=conf, iou=iou, max_det=tcfg.max_det, agnostic=True)
        top2 = ev_scores.topk(2, -1).values
        margin = top2[..., 0] - top2[..., 1]             # (B, A) best class over the next
        flips = nms_order_flips(ev_boxes, ev_scores, yb_scores, conf, iou)
        same = [i for i, t in enumerate(flips) if not t]
        check(len(same) >= nb // 2, f"{nb - len(same)} of {nb} val images have NMS order flips")
        check(torch.equal(got[3][same], want[3][same]),
              f"n_det differs: {got[3].tolist()} vs {want[3].tolist()} (order flips {flips})")
        check(int(want[3].max()) < tcfg.max_det and int(want[3][same].sum()) > 0,
              "the comparison threshold kept no detections or hit max_det")
        box_errs, score_errs, tied, same_cls = [], [], 0, 0
        for i in same:
            n = int(want[3][i])
            err = (got[0][i, :n, None] - want[0][i, None, :n]).abs().amax(-1)
            serr = (got[1][i, :n, None] - want[1][i, None, :n]).abs()
            pair = (err <= box_tol) & (serr <= PRED_TOL["scores"])
            check(bool(pair.any(1).all()) and bool(pair.any(0).all()),
                  f"image {i}: YOLO(best.pt) and validation's EMA model detect different boxes")
            if not n:
                continue
            box_errs.append(float(torch.where(pair, err, float("inf")).amin(1).max()))
            score_errs.append(float(torch.where(pair, serr, float("inf")).amin(1).max()))
            # each reference detection's anchor (its box is that anchor's decoded box)
            anchor = (ev_boxes[i][None] == want[0][i, :n, None]).all(-1).float().argmax(1)
            clear = margin[i, anchor] > 2 * score_err0
            match = got[2][i, pair.float().argmax(0)] == want[2][i, :n]
            check(bool((match | ~clear).all()),
                  f"image {i}: a class differs where no tie explains it")
            tied += int((~clear).sum())
            same_cls += int((match & clear).sum())
        torch.backends.cudnn.allow_tf32 = True
        log(f"[{label} trainer] YOLO(best.pt) vs validation's EMA model, f32, one val batch "
            f"(tolerances {box_tol} px, {PRED_TOL['scores']}): decoded "
            f"boxes max_abs_err {dec_box_err:.3e} px, scores {dec_score_err:.3e}; with the class "
            f"biases at 0 {box_err0:.3e} px and {score_err0:.3e}, and after class-agnostic NMS at "
            f"conf {conf:.6g} and iou {iou:.6g} (gaps of {conf_gap:.3g} between scores and "
            f"{iou_gap:.3g} between IoUs) on the {len(same)} of {nb} images without order flips: "
            f"n_det {want[3][same].tolist()}, paired boxes max_abs_err {max(box_errs):.3e} px, "
            f"scores {max(score_errs):.3e}; classes equal on {same_cls}, {tied} with the best two "
            f"class scores within {2 * score_err0:.3g}")
        return yolo_best

    best_vs_validation(trainer, save_dir, tcfg, best, "yolo11n")

    # per-epoch times
    augment_ms = [s.elapsed_time(e) for s, e in clocks["augment"]]
    step_ms_all = [s.elapsed_time(e) for s, e in clocks["step"]]
    epochs = []
    per_epoch = TRAINER_IMAGES[0] // TRAINER_BATCH
    marks = [(t_train, 0, 0, 0.0, 0.0)] + clocks["rows"]
    for e, (start, (_, a0, v0, m0, _), (t_row, a1, v1, m1, c1)) in enumerate(
            zip(clocks["starts"], marks, marks[1:])):
        epoch_wall = t_row - start   # the steps, the loss read and the validation
        val_s = sum(clocks["val_s"][v0:v1])
        train_s = epoch_wall - val_s - (trainer.cache_build_s if e == 0 else 0.0)
        # an epoch's checkpoints are written after its row, before the next
        c_next = marks[e + 2][4] if e + 2 < len(marks) else clocks["ckpt_s"][-1]
        epochs.append({
            "epoch": e + 1, "mosaic": e < TRAINER_EPOCHS - 1, "wall_s": epoch_wall,
            "train_s": train_s, "train_imgs_per_s": per_epoch * TRAINER_BATCH / train_s,
            "augment_ms_per_batch": float(np.median(augment_ms[a0:a1])),
            "step_ms": float(np.median(step_ms_all[a0:a1])),
            "val_ms_per_batch": val_s * 1e3 / max((v1 - v0) * len(trainer.val_loader), 1),
            "host_metric_ms": (m1 - m0) * 1e3, "checkpoint_ms": (c_next - c1) * 1e3})
    for rec in epochs:
        log(f"[trainer] epoch {rec['epoch']} (mosaic {'on' if rec['mosaic'] else 'off'}): wall "
            f"{rec['wall_s']:.2f} s, train {rec['train_imgs_per_s']:.1f} img/s, augment "
            f"{rec['augment_ms_per_batch']:.2f} ms/batch, step {rec['step_ms']:.2f} ms (CUDA "
            f"events, median), val {rec['val_ms_per_batch']:.1f} ms/batch, host metrics "
            f"{rec['host_metric_ms']:.1f} ms, checkpoints {rec['checkpoint_ms']:.1f} ms")
    log(f"[trainer] device cache built in {trainer.cache_build_s:.2f} s ({TRAINER_IMAGES[0]} "
        f"images decoded and resized on the host, copied to the card)")

    # one more epoch and its validation under torch.profiler
    def trainer_epoch():
        for i, batch in enumerate(trainer._epoch_batches(TRAINER_EPOCHS)):
            trainer.state.step(*trainer.augment(batch, step_seed(args.seed, TRAINER_EPOCHS, i)))
        trainer.validate()

    trainer_busy_ms, trainer_prof_wall_ms = profiled(
        "one Trainer epoch (mosaic off) and its validation", trainer_epoch,
        ("attention_", "nms_", "bwd_"), 15)
    trainer_record = {
        "epochs": epochs, "cache_build_s": trainer.cache_build_s, "dataset_write_s": write_s,
        "train_wall_s": train_wall, "launches": trainer_launches, "results": rows,
        "profiled_epoch_device_busy_ms": trainer_busy_ms,
        "profiled_epoch_wall_ms": trainer_prof_wall_ms, "card": card}

    # 13. score_reduce: the kernel on the class logits the predict and the
    # validation paths handed to decode, bf16 as recorded and an f32 copy,
    # against its plain version; then against batched_nms' front half
    # (sigmoid, then amax/argmax) on the same logits
    mappings_run = set()

    def reduce_parity(label, x):
        s, c = sr.score_reduce(x)
        ps, pc = sr.score_reduce_plain(x)
        torch.cuda.synchronize()
        mapping = sr.reduce_mapping(x.dtype, x.shape, x.stride(), x.data_ptr())
        mappings_run.add(mapping)
        bad = int((c != pc).sum())
        # a NaN logit gives a NaN score in both: equal there, any other NaN fails
        err = torch.where(s.isnan() & ps.isnan(), 0.0, s - ps).abs().max().item()
        log(f"[score_reduce] {label} {tuple(x.shape)} {x.dtype} strides {x.stride()} by "
            f"{mapping}: classes differing {bad}, scores max_abs_err {err:.3e} (tol {SCORE_TOL})")
        check(bad == 0, f"score_reduce {label}: {bad} classes differ from the plain version")
        check(err <= SCORE_TOL, f"score_reduce {label}: scores off by {err}")  # NaN fails
        return s, c, err

    sr.launches = 0
    reduce_err, nms_diffs = 0.0, []
    for key in ("predict", "validation"):
        check(len(logits_rec[key]) > 0, f"no {key} logits were recorded")
        for i, x in enumerate(logits_rec[key]):
            s, c, err = reduce_parity(f"{key} call {i}", x)
            reduce_err = max(reduce_err, err)
            reduce_err = max(reduce_err, reduce_parity(f"{key} call {i} f32", x.float())[2])
            # the front half of batched_nms on the same logits
            sig = torch.sigmoid(x.float())
            fs, fc = sig.amax(-1), sig.argmax(-1).to(torch.int32)
            differ = c != fc
            tie = sig.gather(-1, c.long()[..., None])[..., 0] == fs
            nms_diffs.append(int(differ.sum()))
            check(torch.equal(s, fs), f"{key} call {i}: the max score differs from NMS's")
            check(bool((tie | ~differ).all()), f"{key} call {i}: a class differs without a tie")
    reduce_launches = sr.launches
    log(f"[score_reduce] classes that differ from batched_nms' sigmoid-then-argmax: {nms_diffs} "
        "(each one a tie of f32 sigmoids); the max scores are equal")
    # anchors contiguous (a per-level NCHW map's view): the other thread mapping
    x0 = logits_rec["predict"][0]
    reduce_parity("predict call 0, anchor-contiguous view", x0.transpose(1, 2).contiguous()
                  .transpose(1, 2))
    # crafted rows: exact ties, a row of -inf (f32) or -3e38 (bf16), nc 37
    crafted = torch.randn((4, 512, 37), generator=gen, device=dev)
    crafted[:, :64, 5] = crafted[:, :64, 30] = 40.0           # ties across warp lanes
    crafted[:, 64:128, 3] = crafted[:, 64:128, 4] = 6.0       # ties within a lane's neighbours
    crafted[:, 128:192] = 7.0                                 # every class tied
    for dt, floor in ((torch.float32, float("-inf")), (torch.bfloat16, -3e38)):
        xc = crafted.clone()
        xc[:, 192:200] = floor
        xc = xc.to(dt)
        s, c, _ = reduce_parity("crafted ties and floors, nc 37", xc)
        check(c[:, :64].eq(5).all().item() and c[:, 64:128].eq(3).all().item()
              and c[:, 128:192].eq(0).all().item() and c[:, 192:200].eq(0).all().item(),
              "score_reduce broke a tie away from the lowest class")
        check(s[:, 192:200].eq(0.0).all().item() and s[:, :64].eq(1.0).all().item(),
              "score_reduce floors or saturated scores are off")
        reduce_parity("crafted, anchor-contiguous view", xc.transpose(1, 2).contiguous()
                      .transpose(1, 2))
    # every mapping: widths of whole and partial 16-byte vectors in both
    # dtypes, and a view one element off a 16-byte boundary
    for dt in (torch.bfloat16, torch.float32):
        for nc in (1, 8, 80, 81):
            xw = torch.randn((4, 2100, nc), generator=gen, device=dev) * 3
            xw[:, :16] = 5.0                                     # every class tied
            xw[:, 16:24, nc // 2] = float("nan")                 # a NaN wins
            xw = xw.to(dt)
            reduce_parity(f"nc {nc}", xw)
            flat = torch.empty(xw.numel() + 1, dtype=dt, device=dev)
            flat[1:] = xw.flatten()
            reduce_parity(f"nc {nc}, one element off", flat[1:].view(xw.shape))
            bit_identical(f"score_reduce nc {nc} {dt}", sr.score_reduce, xw)
    log(f"[score_reduce] mappings run: {sorted(mappings_run)}")
    check(mappings_run == set(sr.MAPPINGS),
          f"score_reduce mappings not run: {set(sr.MAPPINGS) - mappings_run}")
    # times at the predict path's shape: the kernel, its plain version, and
    # the library call torch.max(x, -1) followed by the sigmoid of its values
    xb = logits_rec["predict"][0]
    ms, dev_ms, kernel_text, by_kernel = call_and_device_ms(lambda: sr.score_reduce(xb),
                                                            "score_reduce")
    plain_ms = cuda_time_ms(lambda: sr.score_reduce_plain(xb), 50)
    library_ms, lib_dev_ms, library_text, _ = call_and_device_ms(
        lambda: torch.sigmoid(torch.max(xb, dim=-1).values.float()), "torch.max + sigmoid")
    xf = xb.float()
    ms_f32, dev_ms_f32, f32_text, by_kernel_f32 = call_and_device_ms(lambda: sr.score_reduce(xf),
                                                                     "score_reduce f32")
    nbytes = xb.numel() * xb.element_size() + xb.shape[0] * xb.shape[1] * 8
    ops = xb.numel() + xb.shape[0] * xb.shape[1] * 4   # a compare a logit; sigmoid a row
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    kernels.append({
        "name": "score_reduce", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/score_reduce.cu",
        "replaces": "deal_yolo_daya_tpu/ops/pallas/score_reduce.py:28",
        "launches": reduce_launches,
        "launched_on": "phase 13 on the logits the predict and validation paths handed to "
                       "decode; no path calls it (not wired into batched_nms, as in the JAX "
                       "package)",
        "launches_main_paths": {"predict": launches["score_reduce (not on the path)"],
                                "trainer": trainer_launches["score_reduce (not on the path)"]},
        "max_abs_err": reduce_err, "tol": SCORE_TOL, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms,
        "library_device_ms": lib_dev_ms, "shape": list(xb.shape), "dtype": str(xb.dtype),
        "classes_differing_from_nms_front_half": nms_diffs, "device_ms_by_kernel": by_kernel,
        "mapping": sr.reduce_mapping(xb.dtype, xb.shape, xb.stride(), xb.data_ptr()),
        "f32": {"ms": ms_f32, "device_ms": dev_ms_f32, "device_ms_by_kernel": by_kernel_f32},
        "mappings_run": sorted(mappings_run),
    })
    kernels[0]["launches_trainer"] = trainer_launches["area_attention"]
    kernels[1]["launches_trainer"] = trainer_launches["nms_suppress"]
    kernels[1]["mismatched_bits_trainer"] = float(val_mismatched)
    kernels[2]["launches_trainer"] = trainer_launches["area_attention_bwd"]
    log(f"[time] score_reduce {tuple(xb.shape)} {xb.dtype}: kernel {kernel_text}; plain "
        f"{plain_ms:.4f} ms; torch.max + sigmoid {library_text}; bound "
        f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} for {nbytes / 1e6:.2f} MB, ops "
        f"{t_ops:.5f}); f32 input: kernel {f32_text}")
    # 14. yolo12n predict: the same 64 images at batch 32, imgsz 640, bf16,
    # conf 0.001 with the class biases at 0; every attention call of the path
    # is yolo12's AAttn at (key_dim, head_dim) = (32, 32): b6 (area 4) and b8
    # (area 1), two ABlocks of each of two inner modules, 8 a forward
    from deal_yolo_daya_tpu_torch.models.registry import make_detector
    from deal_yolo_daya_tpu_torch.models.yolov12 import YOLOv12

    yolo12 = YOLO("yolo12n", nc=80, imgsz=640, seed=args.seed)
    check(yolo12.family == "yolo12" and yolo12.dtype == torch.bfloat16, "yolo12n handle")
    zero_class_bias(yolo12)
    rec12 = []

    def rec12_attention(qkv, heads, hd, kd=None):
        rec12.append((qkv.clone(), (heads, hd, hd if kd is None else kd)))
        return orig12(qkv, heads, hd, kd)

    n_batches = -(-len(images) // 32)
    with patched(blocks, "area_attention", rec12_attention) as orig12:
        aa.launches = ns.launches = 0
        res12 = yolo12.predict(images, conf=0.001, batch_size=32)
        torch.cuda.synchronize()
        v12_launches = {"area_attention": aa.launches, "nms_suppress": ns.launches}
    log(f"[yolo12n predict] {len(res12)} images, launches {v12_launches}, attention calls "
        f"{sorted({(tuple(q.shape), a) for q, a in rec12})}")
    check(v12_launches["area_attention"] == 8 * n_batches,
          "yolo12n predict: not 8 attention launches a batch")
    check(v12_launches["nms_suppress"] == n_batches, "yolo12n predict: not one NMS a batch")
    check(all(a[1:] == (32, 32) for _, a in rec12), "a yolo12 attention call is not (32, 32)")
    check({tuple(q.shape) for q, _ in rec12} == {(128, 400, 192), (32, 400, 384)},
          "yolo12n's attention shapes at 640 px")
    check(len(res12) == len(images), "yolo12n predict lost images")
    for d in res12:
        check(np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()
              and d.boxes.shape == (len(d), 4), "yolo12n: bad output")
    check(min(len(d) for d in res12) > 0, "yolo12n: an image had no detections")
    fwd32_err = max(attention_parity(f"yolo12n predict call {i}", q, a)
                    for i, (q, a) in enumerate(rec12))
    calls32 = {}  # the first call of each shape: b6 (128, 400, 192), b8 (32, 400, 384)
    for q, a in rec12:
        calls32.setdefault("b6" if q.shape[2] == 192 else "b8", (q, a))
    for site, (q, a) in calls32.items():
        bit_identical(f"attention (32, 32) yolo12n predict {site}", aa.area_attention_fwd, q, *a)
    device12_ms = cuda_time_ms(lambda: yolo12.infer(batch, conf=0.001), 20)
    t0 = time.perf_counter()
    yolo12.predict(images, conf=0.001, batch_size=32)
    wall12 = time.perf_counter() - t0
    log(f"[time] yolo12n predict b32 imgsz 640 bf16: {len(images) / wall12:.1f} img/s end to "
        f"end ({wall12 * 1e3:.1f} ms for {len(images)} images); device infer "
        f"(forward+decode+NMS) {device12_ms:.3f} ms/batch = {32 / device12_ms * 1e3:.1f} img/s")
    busy12_ms, prof12_wall_ms = profiled(
        "yolo12n predict of 64 images", lambda: yolo12.predict(images, conf=0.001, batch_size=32),
        ("attention_", "nms_"), 12)

    # times of the (32, 32) forward at both call shapes: kernel, plain, SDPA, bound
    fwd32 = {}
    for site, (q, (heads, hd, kd)) in calls32.items():
        ba, n, _ = q.shape
        ms, dev_ms, text, by_kernel = call_and_device_ms(
            lambda: aa.area_attention(q, heads, hd, kd), f"area_attention (32, 32) {site}")
        plain_ms = cuda_time_ms(lambda: aa.area_attention_plain(q, heads, hd, kd), 20)
        split = q.view(ba, n, heads, 2 * kd + hd)
        qs, ks, vs = (t.transpose(1, 2) for t in (split[..., :kd], split[..., kd:2 * kd],
                                                  split[..., 2 * kd:]))
        lib_ms, lib_dev_ms, lib_text, _ = call_and_device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs), "sdpa")
        nbytes = q.numel() * q.element_size() * (1 + 2 * heads * hd / q.shape[2])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * ba * heads * n * n * (kd + hd) / BF16_FLOPS * 1e3
        fwd32[site] = {"shape": list(q.shape), "heads": heads, "ms": ms, "device_ms": dev_ms,
                       "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                       "device_ms_by_kernel": by_kernel}
        log(f"[time] area_attention (32, 32) {site} {tuple(q.shape)} {q.dtype}: kernel {text}; "
            f"plain {plain_ms:.4f} ms; sdpa {lib_text}; bound {max(t_bytes, t_ops):.4f} ms "
            f"(bytes {t_bytes:.4f} for {nbytes / 1e6:.2f} MB, ops {t_ops:.4f})")

    # 15. yolo12n train steps: b32 at 640, bf16 autocast, the phase 8 batch;
    # each step launches the (32, 32) forward and backward 8 times each
    cfg12 = TrainConfig(model="yolo12n", imgsz=640, amp=True, seed=args.seed)
    state12 = TrainState(cfg12, nc=80, steps_per_epoch=100, device=dev)
    check(isinstance(state12.model, YOLOv12), "TrainState did not build yolo12n")
    train_x = torch.from_numpy(imgs_np).to(dev)
    train_gt = [torch.from_numpy(a).to(dev)
                for a in bucket_gt(boxes_np, cls_np, mask_np, cfg12.max_boxes)]
    rec12_train = {"fwd": [], "bwd": []}

    def rec12_fwd(qkv, *a):
        if len(rec12_train["fwd"]) < 8:  # the first step's calls
            rec12_train["fwd"].append((qkv.clone(), a))
        return orig12_fwd(qkv, *a)

    def rec12_bwd(qkv, d_out, d_v, *a):
        if len(rec12_train["bwd"]) < 8:
            rec12_train["bwd"].append((qkv.clone(), d_out.clone(), d_v.clone(), a))
        return orig12_bwd(qkv, d_out, d_v, *a)

    totals12, per_step12 = [], []
    with patched(aa, "area_attention_fwd", rec12_fwd) as orig12_fwd, \
            patched(aa, "area_attention_bwd", rec12_bwd) as orig12_bwd:
        aa.launches = aa.bwd_launches = 0
        for _ in range(TRAIN_STEPS):
            before = (aa.launches, aa.bwd_launches)
            totals12.append(state12.step(train_x, *train_gt))
            per_step12.append((aa.launches - before[0], aa.bwd_launches - before[1]))
        torch.cuda.synchronize()
        train12_launches = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches}
    losses12 = [t.item() for t in totals12]
    parts12 = {k: v.item() for k, v in state12.loss_acc.items()}
    log(f"[yolo12n train] losses {losses12}, launches a step (forward, backward) {per_step12}, "
        f"loss parts {parts12}")
    check(all(p == (8, 8) for p in per_step12), "a yolo12n step did not launch 8 + 8 kernels")
    check(all(np.isfinite(losses12)) and parts12["num_fg"] > 0, "yolo12n: bad loss")
    fwd32_err_train = max(attention_parity(f"yolo12n train-path call {i}", q, a)
                          for i, (q, a) in enumerate(rec12_train["fwd"]))
    bwd32_err_train = max(backward_parity(f"yolo12n train-path call {i}", q, do, dv, a)
                          for i, (q, do, dv, a) in enumerate(rec12_train["bwd"]))
    bwd_calls32 = {}
    for q, do, dv, a in rec12_train["bwd"]:
        bwd_calls32.setdefault("b6" if q.shape[2] == 192 else "b8", (q, do, dv, a))
    for site, (q, do, dv, a) in bwd_calls32.items():
        bit_identical(f"attention bwd (32, 32) yolo12n train {site}", aa.area_attention_bwd,
                      q, do, dv, *a)

    # f32 with TF32 off, batch 4: every gradient of a yolo12n step through the
    # kernels against the same step through the plain attention, both with
    # deterministic algorithms, so that no atomic sum's order differs between
    # the two steps (the worst gradient, a BatchNorm bias after the first
    # attention, sits at 0.5-0.9 of the tolerance from card to card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg12_32 = TrainConfig(model="yolo12n", imgsz=640, amp=False, seed=args.seed)
    weights12 = small_box_head(
        init_weights(make_detector("yolo12", "n", 80), args.seed).state_dict(), YOLOv12.DETECT)

    def f32_step12():
        st = TrainState(cfg12_32, nc=80, steps_per_epoch=100, device=dev, state_dict=weights12)
        before = (aa.launches, aa.bwd_launches)
        st.step(x4, *gt4)
        torch.cuda.synchronize()
        return ({n: p.grad for n, p in st.model.named_parameters()},
                {k: v.item() for k, v in st.loss_acc.items()},
                (aa.launches - before[0], aa.bwd_launches - before[1]))

    grads12_k, parts12_k, launched12_k = f32_step12()
    with patched(blocks, "area_attention", aa.area_attention_plain):
        grads12_p, parts12_p, launched12_p = f32_step12()
    check(launched12_k == (8, 8) and launched12_p == (0, 0),
          f"the yolo12n f32 steps took other paths: {launched12_k}, {launched12_p}")
    rtol, atol = GRAD_TOL
    grad12_worst = max(((g - grads12_p[n]).abs().max().item()
                        / (rtol * grads12_p[n].abs().max().item() + atol), n)
                       for n, g in grads12_k.items())
    log(f"[yolo12n train f32] loss parts kernel {parts12_k} plain {parts12_p}; worst gradient "
        f"{grad12_worst[1]} at {grad12_worst[0]:.3f} of the tolerance rtol {rtol} * max |grad| "
        f"+ atol {atol}, over {len(grads12_k)} parameters")
    check(parts12_k["num_fg"] == parts12_p["num_fg"] > 0, "the yolo12n f32 assignments differ")
    check(grad12_worst[0] <= 1.0, f"yolo12n f32 gradient of {grad12_worst[1]} differs")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    del grads12_k, grads12_p

    # times of the (32, 32) backward at both call shapes, and of the step
    bwd32 = {}
    for site, (q, do, dv, (heads, hd, kd)) in bwd_calls32.items():
        ba, n, _ = q.shape
        ms, dev_ms, text, by_kernel = call_and_device_ms(
            lambda: aa.area_attention_bwd(q, do, dv, heads, hd, kd),
            f"area_attention_bwd (32, 32) {site}")
        plain_ms = cuda_time_ms(lambda: aa.area_attention_bwd_plain(q, do, dv, heads, hd, kd), 10)
        split = q.view(ba, n, heads, 2 * kd + hd)
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (split[..., :kd], split[..., kd:2 * kd], split[..., 2 * kd:]))
        out_s = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        grad_s = do.view(ba, n, heads, hd).transpose(1, 2).contiguous()
        lib_ms, lib_dev_ms, lib_text, _ = call_and_device_ms(
            lambda: torch.autograd.grad(out_s, (qs, ks, vs), grad_s, retain_graph=True),
            "sdpa backward")
        lib_fb_ms, lib_fb_dev_ms, lib_fb_text, _ = call_and_device_ms(
            lambda: torch.autograd.grad(torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs), (qs, ks, vs), grad_s), "sdpa forward + backward")
        nbytes = (2 * q.numel() + do.numel() + dv.numel()) * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * ba * heads * n * n * (3 * kd + 2 * hd) / BF16_FLOPS * 1e3
        bwd32[site] = {"shape": list(q.shape), "heads": heads, "ms": ms, "device_ms": dev_ms,
                       "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                       "library_fwd_bwd_device_ms": lib_fb_dev_ms,
                       "device_ms_by_kernel": by_kernel}
        log(f"[time] area_attention_bwd (32, 32) {site} {tuple(q.shape)} {q.dtype}: kernels "
            f"{text}; plain {plain_ms:.4f} ms; sdpa backward {lib_text}; sdpa forward + backward "
            f"{lib_fb_text}; bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} for "
            f"{nbytes / 1e6:.2f} MB, ops {t_ops:.4f})")
    for _ in range(2):
        state12.step(train_x, *train_gt)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TIMED_STEPS):
        state12.step(train_x, *train_gt)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall12_step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    step12_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))[TIMED_STEPS // 2]
    log(f"[time] yolo12n train step b32 imgsz 640 bf16: {step12_ms:.2f} ms (median of "
        f"{TIMED_STEPS}, CUDA events) = {32 / step12_ms * 1e3:.1f} img/s; host wall "
        f"{wall12_step_ms:.2f} ms/step")
    busy12_step_ms, prof12_step_wall_ms = profiled(
        "one yolo12n train step", lambda: state12.step(train_x, *train_gt),
        ("attention_", "bwd_"), 15)
    del state12, train_x, train_gt
    torch.cuda.empty_cache()

    # 16. a yolo12n Trainer run on the shapes dataset of phase 12 (3 epochs
    # at b8, 640, bf16, on-card augmentation, validation after each), its
    # launches, and YOLO(best.pt) coming back as yolo12 and predicting what
    # validation saw
    tcfg12 = FullConfig(model="yolo12n", data=str(data_yaml), imgsz=640, batch=TRAINER12_BATCH,
                        epochs=TRAINER_EPOCHS, close_mosaic=1, cache="device",
                        device_augment=True, amp=True, seed=args.seed, device="0",
                        project=str(root / "runs"), name="smoke12", steps_per_dispatch=1)
    trainer12 = Trainer(tcfg12)
    check(trainer12.family == "yolo12" and isinstance(trainer12.state.model, YOLOv12),
          "the Trainer did not build yolo12n")
    validations12 = []
    validate12 = trainer12.validate

    def counted_validate(*a, **k):
        validations12.append(1)
        return validate12(*a, **k)

    trainer12.validate = counted_validate
    aa.launches = aa.bwd_launches = ns.launches = dk.launches = 0
    t0 = time.perf_counter()
    result12 = trainer12.train()
    torch.cuda.synchronize()
    trainer12_wall = time.perf_counter() - t0
    trainer12_launches = {"area_attention": aa.launches, "area_attention_bwd": aa.bwd_launches,
                          "nms_suppress": ns.launches, "device_augment": dk.launches}
    steps12 = trainer12.state.updates
    val12_batches = len(validations12) * len(trainer12.val_loader)
    log(f"[yolo12n trainer] {TRAINER_EPOCHS} epochs in {trainer12_wall:.1f} s: {steps12} steps, "
        f"{len(validations12)} validations of {len(trainer12.val_loader)} batches; launches "
        f"{trainer12_launches}")
    check(steps12 == TRAINER_EPOCHS * (TRAINER_IMAGES[0] // TRAINER12_BATCH),
          f"the yolo12n Trainer took {steps12} steps")
    check(trainer12_launches == {"area_attention": 8 * (steps12 + val12_batches),
                                 "area_attention_bwd": 8 * steps12,
                                 "nms_suppress": val12_batches, "device_augment": steps12},
          "yolo12n Trainer launches != 8 a forward, 8 a backward, one NMS a val batch, one "
          "augmentation a step")
    save12 = Path(result12["save_dir"])
    best12 = load_checkpoint(save12 / "weights" / "best.pt")
    check(best12["family"] == "yolo12" and "family: yolo12" in (save12 / "args.yaml").read_text(),
          "the yolo12n checkpoint or args.yaml does not record the family")
    with open(save12 / "results.csv", newline="") as f:
        rows12 = list(csv.DictReader(f))
    log(f"[yolo12n trainer] results.csv rows: {rows12}")
    check(len(rows12) == TRAINER_EPOCHS
          and all(np.isfinite(float(r[c])) for r in rows12 for c in loss_cols),
          "yolo12n results.csv: not one row of finite losses an epoch")
    yolo_best12 = best_vs_validation(trainer12, save12, tcfg12, best12, "yolo12n",
                                     PRED_TOL_YOLO12_BOXES_PX)
    check(yolo_best12.family == "yolo12" and isinstance(yolo_best12._model, YOLOv12),
          "YOLO(best.pt) did not come back as yolo12")
    log("[yolo12n trainer] YOLO(best.pt) is yolo12")
    del trainer12
    torch.cuda.empty_cache()

    # 17. yolov8n predict: the same images; no attention, NMS once a batch
    yolo8 = YOLO("yolov8n", nc=80, imgsz=640, seed=args.seed)
    zero_class_bias(yolo8)
    aa.launches = ns.launches = 0
    res8 = yolo8.predict(images, conf=0.001, batch_size=32)
    torch.cuda.synchronize()
    v8_launches = {"area_attention": aa.launches, "nms_suppress": ns.launches}
    with torch.no_grad():
        box8, cls8 = yolo8._fused_model()(batch.permute(0, 3, 1, 2).to(yolo8.dtype))
    shapes8 = [tuple(t.shape) for t in box8 + cls8]
    nb8, side = batch.shape[0], batch.shape[1]
    check(shapes8 == [(nb8, c, side // s, side // s) for c in (64, 80) for s in (8, 16, 32)],
          f"yolov8n head shapes {shapes8}")
    check(all(torch.isfinite(t).all().item() for t in box8 + cls8), "yolov8n: non-finite head")
    check(v8_launches == {"area_attention": 0, "nms_suppress": n_batches},
          f"yolov8n predict launches {v8_launches}")
    check(len(res8) == len(images) and all(np.isfinite(d.boxes).all() for d in res8)
          and min(len(d) for d in res8) > 0, "yolov8n predict outputs")
    t0 = time.perf_counter()
    yolo8.predict(images, conf=0.001, batch_size=32)
    wall8 = time.perf_counter() - t0
    log(f"[yolov8n predict] head shapes {shapes8}; launches {v8_launches}; n_det mean "
        f"{np.mean([len(d) for d in res8]):.1f}; {len(images) / wall8:.1f} img/s end to end")

    # the (32, 32) builds' rows of the kernels line: the b6 call shape as the
    # row's, both shapes under "calls"
    for name, src, line, recs, err, launches_predict, launches_train in (
            ("area_attention (32, 32)", "area_attention.cu", 46, fwd32,
             max(fwd32_err, fwd32_err_train), v12_launches["area_attention"],
             train12_launches["area_attention"]),
            ("area_attention_bwd (32, 32)", "area_attention_bwd.cu", 69, bwd32, bwd32_err_train,
             0, train12_launches["area_attention_bwd"])):
        b6 = recs["b6"]
        bwd_row = "bwd" in name
        kernels.append({
            "name": name, "route": "cuda", "source": f"deal_yolo_daya_tpu_torch/csrc/{src}",
            "replaces": f"deal_yolo_daya_tpu/ops/pallas/area_attention.py:{line}",
            "launches": launches_train if bwd_row else launches_predict,
            "launches_by_path": {"yolo12n predict": launches_predict,
                                 "yolo12n train steps": launches_train,
                                 "yolo12n Trainer": trainer12_launches[
                                     "area_attention_bwd" if bwd_row else "area_attention"]},
            "max_abs_err": err, "tol": BWD_TOL["bfloat16"] if bwd_row else ATTN_TOL["bfloat16"],
            "ms": b6["ms"], "device_ms": b6["device_ms"], "plain_ms": b6["plain_ms"],
            "bound_ms": b6["bound_ms"], "bound_by": b6["bound_by"],
            "library_ms": b6["library_ms"], "library_device_ms": b6["library_device_ms"],
            "shape": b6["shape"], "dtype": "torch.bfloat16", "calls": recs})
    family_record = {
        "yolo12n_predict": {"imgs_per_s_e2e": len(images) / wall12,
                            "device_ms_per_b32": device12_ms, "profiled_device_busy_ms": busy12_ms,
                            "profiled_wall_ms": prof12_wall_ms, "launches": v12_launches},
        "yolo12n_train": {"ms_per_step": step12_ms, "imgs_per_s": 32 / step12_ms * 1e3,
                          "host_wall_ms_per_step": wall12_step_ms, "losses": losses12,
                          "launches_per_step": per_step12,
                          "f32_grad_worst_of_tol": grad12_worst[0],
                          "profiled_device_busy_ms": busy12_step_ms,
                          "profiled_wall_ms": prof12_step_wall_ms},
        "yolo12n_trainer": {"wall_s": trainer12_wall, "launches": trainer12_launches,
                            "results": rows12},
        "yolov8n_predict": {"imgs_per_s_e2e": len(images) / wall8, "launches": v8_launches},
        "card": card}
    # 18. yolo11n serving: an Engine over phase 5's handle (class biases at
    # 0, conf 0.001), one CUDA graph a bucket. The launch counts move while
    # warmup() runs each bucket's eager warm-up runs and its capture, and
    # never while a graph replays: inside the graphs the kernels are seen by
    # the profiler, and every served batch leaves the counts where they were
    import threading
    import urllib.error
    import urllib.request

    from deal_yolo_daya_tpu_torch import serve
    from deal_yolo_daya_tpu_torch.ops.png import write_png
    from deal_yolo_daya_tpu_torch.serve import Engine, serve_http

    # the load generator of tools/bench_serve_torch.py
    spec = importlib.util.spec_from_file_location(
        "bench_serve_torch", Path(__file__).resolve().parent / "tools" / "bench_serve_torch.py")
    bench_serve_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_serve_torch)
    drive_load = bench_serve_torch.drive_load
    from deal_yolo_daya_tpu_torch.train.trainer import make_config

    serve_x = torch.from_numpy(np.stack([letterbox_numpy(im, 640)[0] for im in images[:32]])
                               ).to(dev)

    def counts():
        return aa.launches, ns.launches

    def capture_all(engine, label, per_forward):
        """warmup() bucket by bucket: each moves the counts by its eager
        warm-up runs (the capture launches nothing); a second warmup()
        moves nothing."""
        rec = {}
        for b in engine.buckets():
            before = counts()
            engine.warmup([b])
            moved = tuple(a - z for a, z in zip(counts(), before))
            prog = engine.program(b)
            runs = serve.WARMUP_RUNS
            check(moved == tuple(runs * n for n in per_forward),
                  f"{label} bucket {b}: warm-up and capture moved the counts by {moved}")
            rec[b] = {"capture_s": prog.capture_s, "pool_mb": prog.pool_bytes / 1e6}
            log(f"[serve {label}] bucket {b}: captured in {prog.capture_s * 1e3:.1f} ms "
                f"({serve.WARMUP_RUNS} eager warm-up runs included), graph pool "
                f"{prog.pool_bytes / 1e6:.1f} MB, counts moved {moved} (attention, NMS)")
        before = counts()
        engine.warmup()
        check(counts() == before, f"{label}: a second warmup() captured again")
        return rec

    def replays_equal_eager(engine, handle, label, per_forward):
        """Each bucket's replay on a batch of phase 5's canvases against the
        eager ``YOLO.infer`` on the same batch: every output bit for bit. The
        eager run's attention and NMS inputs, which the graph's kernels get
        too, are recorded, and each kernel is held against its plain version
        on them (attention at ATTN_TOL, and on random qkv of the same
        shapes; NMS bit for bit)."""
        rec = {}
        for b in engine.buckets():
            prog = engine.program(b)
            prog.images.copy_(serve_x[:b])
            before = counts()
            prog.replay()
            got = [t.clone() for t in prog.outputs]
            replay_moved = tuple(a - z for a, z in zip(counts(), before))
            calls = {"attn": [], "nms": []}

            def rec_attention(qkv, *a):
                calls["attn"].append((qkv.clone(), a))
                return orig_attention(qkv, *a)

            def rec_suppress(boxes, valid, thr):
                calls["nms"].append((boxes.clone(), valid.clone(), thr))
                return orig_suppress(boxes, valid, thr)

            with patched(blocks, "area_attention", rec_attention) as orig_attention, \
                    patched(nms_ops, "nms_suppress", rec_suppress) as orig_suppress:
                want = handle.infer(serve_x[:b], conf=engine.conf, iou=engine.iou,
                                    max_det=engine.max_det)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            log(f"[serve {label}] bucket {b}: replay vs eager infer bit-identical {same}, n_det "
                f"{got[3].tolist()}, counts moved by the replay {replay_moved}")
            check(replay_moved == tuple(per_forward), f"{label} bucket {b}: the replay counted "
                  f"{replay_moved} launches, not {tuple(per_forward)}")
            check(same, f"{label} bucket {b}: the replay differs from the eager infer")
            check((len(calls["attn"]), len(calls["nms"])) == tuple(per_forward),
                  f"{label} bucket {b}: the eager infer called (attention, NMS) "
                  f"{(len(calls['attn']), len(calls['nms']))} times, not {tuple(per_forward)}")
            attn_err = max((attention_parity(f"{label} bucket {b} call {i}", q, a)
                            for i, (q, a) in enumerate(calls["attn"])), default=None)
            # the path's attention outputs are small: random qkv of each of
            # the bucket's call shapes too, so a wrong kernel cannot hide
            # under the absolute tolerance
            shapes = sorted({(tuple(q.shape), q.dtype, a) for q, a in calls["attn"]}, key=str)
            random_err = max((attention_parity(
                f"{label} bucket {b} random", torch.randn(sh, generator=gen, device=dev).to(dt), a)
                for sh, dt, a in shapes), default=None)
            nms_bad = sum(nms_parity(f"{label} bucket {b}", bx, v, t)
                          for bx, v, t in calls["nms"])
            rec[b] = {"attention_shapes": sorted({tuple(q.shape) for q, _ in calls["attn"]}),
                      "attention_max_abs_err": attn_err,
                      "attention_random_max_abs_err": random_err,
                      "nms_shape": tuple(calls["nms"][0][0].shape),
                      "nms_mismatched_bits": nms_bad}
        return rec

    def profiled_replay(engine, b, label, per_forward):
        """One replay of bucket b under torch.profiler: the attention-forward
        and NMS kernels, found by name, once a launch site."""
        prog = engine.program(b)
        prog.replay()
        torch.cuda.synchronize()
        for attempt in range(3):  # the card's profiler has dropped whole windows
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prog.replay()
                torch.cuda.synchronize()
            rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
            found = {site: [r for r in rows if word in r[0]]
                     for site, word in (("attention", "attention_"), ("nms", "nms_"))}
            seen = tuple(sum(r[1] for r in found[site]) for site in ("attention", "nms"))
            if seen == tuple(per_forward):
                break
            log(f"[serve {label}] profiled replay {attempt}: {len(rows)} device activities, "
                f"(attention, NMS) {seen}; taking another")
            time.sleep(1.0)
        ms = {site: sum(r[2] for r in found[site]) / max(n, 1)
              for site, n in zip(("attention", "nms"), seen)}
        log(f"[serve {label}] one replay of bucket {b} under the profiler: {len(rows)} device "
            f"activities, {sum(r[2] for r in rows):.3f} ms busy; attention kernels "
            f"{[(k[:60], n) for k, n, _ in found['attention']]}, NMS "
            f"{[(k[:60], n) for k, n, _ in found['nms']]}; inside the graph attention "
            f"{ms['attention']:.4f} ms a launch, NMS {ms['nms']:.4f} ms")
        check(seen == tuple(per_forward), f"{label}: the graph launched (attention, NMS) {seen}, "
              f"not {tuple(per_forward)}")
        return {"launches": dict(zip(("attention", "nms"), seen)), "device_ms_a_launch": ms,
                "busy_ms": sum(r[2] for r in rows)}

    def host_and_device_ms(fn, n=20):
        """Median host wall of a call (enqueue) and its device time (CUDA
        events around it), warm."""
        fn()
        host, device = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            fn()
            e1.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            device.append(e0.elapsed_time(e1))
        return float(np.median(host)), float(np.median(device))

    t_serve = time.perf_counter()
    engine = Engine(yolo, max_batch=32, conf=0.001, iou=0.7)
    captures11 = capture_all(engine, "yolo11n", (1, 1))
    parity11 = replays_equal_eager(engine, yolo, "yolo11n", (1, 1))
    graph11 = profiled_replay(engine, 32, "yolo11n", (1, 1))
    log(f"[serve yolo11n] standalone (phase 6): attention {kernels[0]['device_ms']:.4f} ms, NMS "
        f"{kernels[1]['device_ms']:.4f} ms")
    # the futures against predict on batches of the same composition: 32 in
    # one burst under a 2 s deadline form one bucket-32 batch
    engine.max_wait_s = 2.0
    before = counts()
    with engine:
        futs = [engine.submit(im) for im in images[:32]]
        served = [f.result(timeout=300) for f in futs]
    burst = engine.stats()
    check(counts() == tuple(a + burst["batches"] for a in before),
          f"the burst's batch counted {counts()} launches from {before}")
    check(burst["batches"] == 1 and burst["errors"] == 0, f"the burst of 32: {burst}")
    same_detections(served, yolo.predict(images[:32], conf=0.001, iou=0.7, batch_size=32),
                    "Engine burst of 32 vs predict(batch_size=32)")
    engine1 = Engine(yolo, max_batch=1, conf=0.001, iou=0.7)
    capture_all(engine1, "yolo11n max_batch 1", (1, 1))
    before = counts()
    with engine1:
        served1 = [engine1.submit(im).result(timeout=300) for im in images[:16]]
    check(counts() == tuple(a + len(served1) for a in before),
          f"{len(served1)} batches of one counted {counts()} launches from {before}")
    same_detections(served1, yolo.predict(images[:16], conf=0.001, iou=0.7, batch_size=1),
                    "Engine max_batch 1 vs predict(batch_size=1)")
    log(f"[serve yolo11n] futures equal predict bit for bit: a burst of 32 (one batch) and 16 "
        "one at a time at max_batch 1")

    # load windows on phase 5's 64 mixed-size images, letterboxed on the
    # clients' threads; the counts set to 0 just before and read just after
    engine.max_wait_s = 0.005
    aa.launches = ns.launches = 0
    with engine:
        closed = drive_load(engine, images, clients=16, seconds=SERVE_SECONDS)
        opened = drive_load(engine, images, clients=16, seconds=OPEN_SECONDS,
                            rate=closed["imgs_per_s"] / 2)
    with engine1:
        floor = drive_load(engine1, images, clients=16, seconds=SERVE_SECONDS)
    serve_launches = {"area_attention": aa.launches, "nms_suppress": ns.launches}
    for label, rec in (("closed loop, max_batch 32", closed), ("open loop at half rate", opened),
                       ("closed loop, max_batch 1", floor)):
        log(f"[serve yolo11n] {label}, 16 clients, {rec['seconds']:.1f} s: "
            f"{rec['imgs_per_s']:.1f} img/s; request p50 {rec.get('client_p50_ms', 0):.2f} ms, "
            f"p95 {rec.get('client_p95_ms', 0):.2f} ms (letterbox included; engine-side "
            f"{rec.get('p50_ms', 0):.2f} / {rec.get('p95_ms', 0):.2f} ms); avg_batch "
            f"{rec['avg_batch']:.2f}, pad_fraction {rec['pad_fraction']:.4f}, errors "
            f"{rec['errors']} + {rec['client_errors']}")
        check(rec["errors"] == 0 and rec["client_errors"] == 0 and rec["completed"] > 0,
              f"serving {label}: {rec}")
    # one attention forward and one NMS a served batch, each a replay
    served_batches = sum(rec["batches"] for rec in (closed, opened, floor))
    check(serve_launches == {"area_attention": served_batches, "nms_suppress": served_batches},
          f"the serving windows' {served_batches} batches counted {serve_launches} launches")
    # what the graphs buy: one replay against one eager infer on the same batch
    replay_vs_eager = {}
    for b in (1, 8, 32):
        prog = engine.program(b)
        prog.images.copy_(serve_x[:b])
        r_host, r_dev = host_and_device_ms(prog.replay)
        e_host, e_dev = host_and_device_ms(lambda: yolo.infer(serve_x[:b], conf=0.001))
        replay_vs_eager[b] = {"replay_host_ms": r_host, "replay_device_ms": r_dev,
                              "eager_host_ms": e_host, "eager_device_ms": e_dev}
        log(f"[serve yolo11n] bucket {b}: replay host {r_host:.3f} ms, device {r_dev:.3f} ms; "
            f"eager infer host {e_host:.3f} ms, device {e_dev:.3f} ms (median of 20)")

    # 19. the HTTP frontend over the Engine on a free port
    server = serve_http(engine, host="127.0.0.1", port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    http_thread = threading.Thread(target=server.serve_forever, daemon=True)
    http_thread.start()

    def post(body):
        req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        check(json.loads(r.read()) == {"ok": True}, "GET /healthz")
    write_png(root / "http.png", images[0])
    code, answer = post((root / "http.png").read_bytes())
    det = engine.submit(images[0]).result(timeout=120)
    expect = {"boxes": np.asarray(det.boxes, np.float64).round(2).tolist(),
              "scores": np.asarray(det.scores, np.float64).round(4).tolist(),
              "classes": np.asarray(det.classes, np.int64).tolist(),
              "names": [yolo.names[int(c)] for c in det.classes], "num": len(det)}
    check(code == 200 and answer == expect and answer["num"] > 0,
          f"POST /predict of a PNG: {code}, {answer['num'] if code == 200 else answer}")
    with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
        http_stats = json.loads(r.read())
    try:
        import cv2

        jpeg, jpeg_code = cv2.imencode(".jpg", images[0][..., ::-1])[1].tobytes(), 200
    except ImportError:
        jpeg, jpeg_code = b"\xff\xd8\xff\xe0" + bytes(64), 415  # no decoder
    code_jpeg, _ = post(jpeg)
    code_bad, bad = post(b"not an image")
    server.shutdown()
    server.server_close()
    http_thread.join(timeout=30)
    engine.shutdown()
    log(f"[http] /healthz ok; POST /predict of a PNG: {answer['num']} detections, equal to the "
        f"Engine's; a JPEG body answers {code_jpeg}; a body no decoder reads answers {code_bad} "
        f"({bad['error'][:80]}); /stats completed {http_stats['completed']}")
    check(code_jpeg == jpeg_code and code_bad == 415 and not http_thread.is_alive(),
          "the HTTP frontend's answers or its shutdown")
    del engine, engine1
    torch.cuda.empty_cache()

    # 20. yolo12n and yolov8n serving, max_batch 8: yolo12n's graphs hold 8
    # (32, 32) attention launches and one NMS, yolov8n's one NMS
    serving_families = {}
    for label, handle, per_forward in (("yolo12n", yolo12, (8, 1)), ("yolov8n", yolo8, (0, 1))):
        eng = Engine(handle, max_batch=8, conf=0.001, iou=0.7)
        caps = capture_all(eng, label, per_forward)
        parity = replays_equal_eager(eng, handle, label, per_forward)
        serving_families[label] = {"captures": caps, "kernels_vs_plain": parity,
                                   "graph": profiled_replay(eng, 8, label, per_forward)}
        del eng
        torch.cuda.empty_cache()

    # 21. export/from_export and val, from phase 12's best.pt: the bundle
    # predicts bit for bit as its source, and val() returns what the
    # Trainer's validate() gives on the same weights and config
    best_handle = YOLO(str(save_dir / "weights" / "best.pt"), device=dev)
    bundle = best_handle.export(root / "bundle")
    exported = YOLO.from_export(bundle, device=dev)
    check((exported.family, exported.nc, exported.names, exported.imgsz)
          == (best_handle.family, best_handle.nc, best_handle.names, best_handle.imgsz),
          "from_export lost the family, nc, names or imgsz")
    same_detections(exported.predict(images[:32], conf=0.001, batch_size=32),
                    best_handle.predict(images[:32], conf=0.001, batch_size=32),
                    "from_export vs its source")
    val_kw = dict(device="0", imgsz=640, project=str(root / "runs"))
    got_val = best_handle.val(str(data_yaml), name="val", **val_kw)
    want_val, _ = Trainer(make_config("yolo11n", str(data_yaml), name="val_direct", **val_kw),
                          init_state_dict=inference_state_dict(best)).validate()
    val_err = max(float(np.abs(np.asarray(got_val[k]) - np.asarray(want_val[k])).max())
                  for k in ("precision", "recall", "map50", "map"))
    log(f"[export] {sorted(p.name for p in bundle.iterdir())}: from_export predicts bit for bit "
        f"as best.pt on 32 images; val() {({k: got_val[k] for k in ('map50', 'map')})}, "
        f"Trainer.validate() {({k: want_val[k] for k in ('map50', 'map')})}, largest "
        f"difference {val_err:.3e}")
    check(val_err <= 1e-6, f"val() differs from Trainer.validate() by {val_err}")
    serve_s = time.perf_counter() - t_serve
    log(f"[serve] phases 18-21 in {serve_s:.1f} s")
    del best_handle, exported, trainer
    torch.cuda.empty_cache()

    # 22. the train step as a CUDA graph against the eager step: yolo11n at
    # b32 and yolo12n at b8, 640, bf16, the device cache and the on-card
    # augmentation
    t_graph = time.perf_counter()
    graph_record = {"yolo11n": graph_vs_eager(args.seed, "yolo11n", 32, (1, 1), card),
                    "yolo12n": graph_vs_eager(args.seed, "yolo12n", TRAINER12_BATCH, (8, 8),
                                              card)}
    torch.cuda.empty_cache()

    # 23. the slice's main path: the yolo11n Trainer on phase 12's shapes
    # dataset with steps_per_dispatch auto (K = 8: one dispatch an epoch;
    # close_mosaic makes a second program), checkpoints in the background,
    # validation after each epoch; then the same run with K = 1
    gcfg = FullConfig(model="yolo11n", data=str(data_yaml), imgsz=640, batch=TRAINER_BATCH,
                      epochs=TRAINER_EPOCHS, close_mosaic=1, seed=args.seed, device="0",
                      project=str(root / "runs"), name="graphed")
    trainer_g, _, graphed_run = trainer_run(gcfg, "graphed")
    check(trainer_g.steps_per_dispatch(len(trainer_g.train_loader)) == 8 and
          trainer_g.cfg.cache == "device" and trainer_g.cfg.device_augment,
          "the default Trainer did not take the graphed device-cache path")
    del trainer_g
    # the same run under the profiler: its launches on the card against the
    # counters (each graph's replays included)
    graphed_run["profiled_launches"] = profiled_trainer_launches(gcfg)
    torch.cuda.empty_cache()
    trainer_e, _, eager_run = trainer_run(dataclasses.replace(gcfg, name="eager",
                                                              steps_per_dispatch=1), "K=1")
    del trainer_e
    torch.cuda.empty_cache()

    # 24. an epoch with device_augment=False: the host augmentation, streamed
    host_aug = host_augment_epoch(dataclasses.replace(
        gcfg, name="host_aug", epochs=1, device_augment=False, val=False), "host augment")
    torch.cuda.empty_cache()

    # 25. remat
    remat_record = remat_checks(args.seed, card)

    # 26. batch=-1, and the default Trainer at the batch it picks on phase
    # 12's train images listed AUTOBATCH_REPEATS times (two batches at the cap)
    ab_yaml = repeated_dataset(data_yaml, root / "autobatch_data", AUTOBATCH_REPEATS)
    autobatch_record = autobatch_run(dataclasses.replace(
        gcfg, data=str(ab_yaml), name="autobatch", batch=-1, epochs=2, close_mosaic=0,
        steps_per_dispatch=2), card)
    torch.cuda.empty_cache()

    # 27. profile_steps=2
    profile_record = profile_steps_run(dataclasses.replace(
        gcfg, name="profiled", epochs=1, profile_steps=2, val=False))

    # 28. the synth yardstick: yolo11n, 30 epochs at 320 on 600 + 100 shapes,
    # the graphed step (tools/train_synth_torch.py)
    spec = importlib.util.spec_from_file_location(
        "train_synth_torch", Path(__file__).resolve().parent / "tools" / "train_synth_torch.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    t0 = time.perf_counter()
    synth_yaml = synth.dataset(root / "synth")
    synth_write_s = time.perf_counter() - t0
    yardstick = synth.run(synth_yaml, root / "synth", "graphed", seed=args.seed, device="0")
    log(f"[yardstick] dataset written in {synth_write_s:.1f} s; "
        f"{yardstick['epochs']} epochs in {yardstick['wall_s']:.1f} s: mAP50 "
        f"{yardstick['map50']:.4f}, mAP50-95 {yardstick['map']:.4f} (floor mAP50 "
        f"{YARDSTICK_MAP50}); mAP50 by epoch {[round(v, 3) for v in yardstick['map50_by_epoch']]}")
    check(yardstick["map50"] >= YARDSTICK_MAP50, f"the yardstick reached mAP50 "
          f"{yardstick['map50']:.4f} < {YARDSTICK_MAP50}")
    graph_s = time.perf_counter() - t_graph
    log(f"[graph] phases 22-28 in {graph_s:.1f} s")

    # 29-34. w8a8 and ultralytics checkpoints: int8 predict (the slice's main
    # path), the s8 conv against its plain version, the int8 Engine, int8
    # bundles, an ultralytics .pt in and fine-tuned, the yardstick in int8
    t_int8 = time.perf_counter()
    q11, q_batch, conv_inputs, int8_record = int8_predict_phase(args.seed, images, yolo)
    s8_row = s8_conv_checks(q11, q_batch, conv_inputs, args.seed)
    s8_row["launches"] = int8_record["launches"]["int8_conv"]
    del conv_inputs
    int8_record["engine"] = int8_engine_phase(q11, q_batch, yolo)
    int8_record["export"] = int8_export_phase(q11, images, root / "bundle_int8")
    del q11
    torch.cuda.empty_cache()
    int8_record["ultralytics"] = ultralytics_phase(save_dir / "weights" / "best.pt", data_yaml,
                                                   root, images, args.seed, FullConfig)
    int8_record["yardstick"] = int8_yardstick_phase(yardstick["save_dir"], synth_yaml, root)
    int8_record["wall_s"] = time.perf_counter() - t_int8

    # 35. data parallelism on the one card: a 1-rank NCCL group (the graphed
    # step with its collectives captured), two gloo ranks, the Trainer's
    # device grammar
    dp_record = dp_phase(args.seed, data_yaml, root, card, FullConfig)

    # 36. the app: the probes, the golden chain, the nine steps, the IoU
    # filter on the card and the training page's call path
    app_record = app_phase(args.seed, root, card)

    # 37. export_stablehlo/load_stablehlo: the portable and the kernels
    # artifacts of yolo11n, yolo12n's kernels artifact, NMS with the
    # threshold in device memory
    export_record = export_phase(yolo, yolo12, batch, nms_inputs, nms_times, root, card)
    kernels[0].setdefault("launches_by_path", {})["yolo11n kernels artifact, a b32 call"] = \
        export_record["launches_b32"]["kernels"][0]
    kernels[1].setdefault("launches_by_path", {})["yolo11n kernels artifact, a b32 call"] = \
        export_record["launches_b32"]["kernels"][1]
    kernels[4]["launches_by_path"][f"yolo12n kernels artifact, a b{EXPORT12_BATCH} call"] = \
        export_record["yolo12n_b8"]["launches"][0]

    # 38. predict's video, URL and save sources
    sources_record = sources_phase(yolo, images, root, card)

    # 39. tensor parallelism on the one card: two gloo ranks of a 1 x 2 mesh
    # against one process (yolo11n in bf16, yolo11x in f32) and a 1 x 2
    # Trainer, whose best.pt must load whole and equal validation's model
    tp_record, tp_trainer, tp_cfg, tp_dir = tp_phase(args.seed, data_yaml, root, card, FullConfig)
    best_vs_validation(tp_trainer, tp_dir, tp_cfg,
                       load_checkpoint(tp_dir / "weights" / "best.pt"), "tp 1x2")
    del tp_trainer
    torch.cuda.empty_cache()

    # 40. validation's files and its native matcher
    finish_record = plots_matcher_phase(args.seed, data_yaml, root,
                                        tp_dir / "weights" / "best.pt", card, FullConfig)
    tmp.cleanup()

    # 41. the phase stamps in the step graph, against their counters, CUDA
    # events and the profiler
    stamp_record = phase_stamp_checks(args.seed, card)

    # 42. the augmentation's pixel kernel against its plain version, in a CUDA
    # graph, and its times
    aug_record = device_augment_checks(args.seed, card)

    # 43. the attention kernels' (36, 72) builds (yolov10m's PSA) against their
    # plain versions, in a CUDA graph, and their times
    k36_record = k36_attention_checks(args.seed, card)

    # 44. the task-aligned assigner's kernels against their plain version, in
    # the yolo11n and yolov10m step graphs, and their times
    tal_record = tal_assign_checks(args.seed, card)

    # 45. train-mode BatchNorm + SiLU against its plain version, in a CUDA graph
    # and in the three train cells' step graphs, and its times
    bn_record = bn_act_checks(args.seed, card)
    int8_record["card"] = card
    s8_row["launches_by_path"] = {
        "int8 predict": int8_record["launches"]["int8_conv"],
        **{f"int8 predict, {rt} route": int8_record["launches"][f"int8_conv {rt}"]
           for rt in S8_ROUTES},
        "int8 serving graph (b32 replay, profiler)":
            int8_record["engine"]["graph_launches"]["int8_conv"]}
    kernels.append(s8_row)
    kernels.append({
        "name": "phase_stamp", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/phase_stamp.cu", "replaces": None,
        "launches": stamp_record["launches"], "device_ms": stamp_record["stamp_us"] / 1e3,
        "launches_by_path": {f"yolo11n b32 graphed step, {STAMP_REPLAYS} replays":
                             stamp_record["launches"],
                             f"yolov10m b32 graphed step (phase 43), {K36_STEP_REPLAYS} "
                             "replays": k36_record["step_graph"]["launches"]["stamps"],
                             f"loss mark, yolov10m b32 graphed step (phase 43), "
                             f"{K36_STEP_REPLAYS} replays":
                                 k36_record["step_graph"]["launches"]["mark"]},
        "phases": stamp_record})
    kernels.append({
        "name": "device_augment", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/device_augment.cu", "replaces": None,
        "launches": aug_record["graph_launches"], "shape": aug_record["shape"],
        "device_ms": aug_record["device_ms"], "ms": aug_record["call_ms"],
        "plain_ms": aug_record["plain_ms"], "bound_ms": aug_record["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {
            "phase 42, apply a call": aug_record["cases"]["default"]["launches"],
            f"phase 42, a CUDA graph of apply, {AUG_REPLAYS} replays": aug_record["graph_launches"],
            f"yolo11n b32 graphed step (phase 22), {GRAPH_STEPS} steps":
                graph_record["yolo11n"]["augment_launches_first_dispatch"],
            f"yolo11n b32 graphed step (phase 41), {STAMP_REPLAYS} replays":
                stamp_record["augment_launches"],
            "yolo11n Trainer (phase 12)": trainer_record["launches"]["device_augment"],
            "yolo11n graphed Trainer (phase 23)": graphed_run["launches"]["device_augment"],
            "yolo11n Trainer K = 1 (phase 23)": eager_run["launches"]["device_augment"],
            f"yolo11n 1 x 2 TP Trainer, rank 0, {TP_TRAINER_STEPS} steps b{TP_BATCH}":
                tp_record["trainer_1x2"]["launches"]["device_augment"]},
        "checks": aug_record})
    for which, name, err in (("forward", "area_attention", "fwd"),
                             ("backward", "area_attention_bwd", "bwd")):
        t = k36_record[which]
        kernels.append({
            "name": name, "build": "(36, 72)", "route": "cuda",
            "source": f"deal_yolo_daya_tpu_torch/csrc/{name}.cu", "replaces": None,
            "shape": k36_record["shape"], "dtype": "torch.bfloat16",
            "max_abs_err": k36_record["max_abs_err"]["bfloat16 32x400"][err],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "device_ms_by_kernel": t["device_ms_by_kernel"],
            "launches_by_path": {
                "phase 43, a call": k36_record["call_launches"][0 if which == "forward" else 1],
                f"phase 43, a CUDA graph of forward + backward, {K36_GRAPH_REPLAYS} replays":
                    k36_record["graph_launches"][0 if which == "forward" else 1],
                f"yolov10m b32 graphed step (phase 43), {K36_STEP_REPLAYS} replays":
                    k36_record["step_graph"]["launches"][
                        "k36" if which == "forward" else "k36_bwd"]}})
    kernels.append({
        "name": "tal_assign", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/tal_assign.cu", "replaces": None,
        "shape": tal_record["shape"], "device_ms": tal_record["device_ms"],
        "ms": tal_record["call_ms"], "plain_ms": tal_record["plain_ms"],
        "bound_ms": tal_record["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {
            f"{model} b32 graphed step (phase 44), {TAL_STEP_REPLAYS} replays":
                tal_record["steps"][model]["launches"] for model, _ in TAL_CELLS},
        "checks": tal_record})
    kernels.append({
        "name": "batch_norm_act", "route": "cuda",
        "source": "deal_yolo_daya_tpu_torch/csrc/batch_norm_act.cu", "replaces": None,
        "times": bn_record["times"], "bound_by": "bytes", "library": "ATen native_batch_norm + silu",
        "launches_by_path": {
            f"{model} b32 graphed step (phase 45), a replay":
                bn_record["steps"][model]["launches_a_replay"] for model in BN_STEP_CELLS},
        "checks": bn_record})
    log(f"[int8] phases 29-34 in {int8_record['wall_s']:.1f} s")
    kernels[0]["train_graph_launches"] = {
        "yolo11n": graph_record["yolo11n"]["replay_launches"]["forward"],
        "yolo11n remat": remat_record["replay_launches"][0]}
    kernels[2]["train_graph_launches"] = {
        "yolo11n": graph_record["yolo11n"]["replay_launches"]["backward"],
        "yolo11n remat": remat_record["replay_launches"][1]}
    kernels[4]["train_graph_launches"] = {
        "yolo12n": graph_record["yolo12n"]["replay_launches"]["forward"]}
    kernels[5]["train_graph_launches"] = {
        "yolo12n": graph_record["yolo12n"]["replay_launches"]["backward"]}
    for row, key in ((kernels[0], "area_attention"), (kernels[1], "nms_suppress"),
                     (kernels[2], "area_attention_bwd")):
        row.setdefault("launches_by_path", {})["yolo11n graphed Trainer"] = \
            graphed_run["launches"][key]
    for row, i in ((kernels[0], 0), (kernels[2], 1)):
        row["launches_by_path"][f"yolo11n DP 1-rank NCCL, {DP_GRAPH_STEPS} graph replays"] = \
            dp_record["nccl_1rank"]["launches_replays"][i]
        row["launches_by_path"][f"yolo11n DP 2 gloo ranks, {DP_STEPS} steps, per rank"] = \
            {r: n[i] for r, n in dp_record["gloo_2ranks"]["launches_per_rank"].items()}
    for row, key in ((kernels[0], "area_attention"), (kernels[1], "nms_suppress"),
                     (kernels[2], "area_attention_bwd")):
        row["launches_by_path"][f"yolo11n training page (thread), {APP_IMGSZ} b{APP_BATCH}, "
                                f"{APP_EPOCHS} epochs"] = app_record["train"]["launches"][key]
        row["launches_by_path"][f"yolo11n 1 x 2 TP Trainer, rank 0, {TP_TRAINER_STEPS} steps "
                                f"b{TP_BATCH}"] = tp_record["trainer_1x2"]["launches"][key]
    for row, i in ((kernels[0], 0), (kernels[2], 1)):
        row["launches_by_path"][f"yolo11n TP 1 x 2 gloo ranks, {TP_STEPS} steps, per rank"] = \
            {r: n[i] for r, n in tp_record["gloo_1x2"]["launches_per_rank"].items()}
        row["launches_by_path"]["yolo11x TP 1 x 2 gloo ranks, one f32 step, per rank"] = \
            [n[i] for n in tp_record["yolo11x_f32"]["launches_per_rank"]]
    train_graph_record = {
        "graph_vs_eager": graph_record, "trainer_graphed": graphed_run,
        "trainer_k1": eager_run, "host_augment": host_aug, "remat": remat_record,
        "autobatch": autobatch_record, "profile_steps": profile_record,
        "yardstick": yardstick, "wall_s": graph_s, "card": card}

    kernels[0]["serving_graph_launches"] = {"yolo11n": graph11["launches"]["attention"]}
    kernels[1]["serving_graph_launches"] = {
        "yolo11n": graph11["launches"]["nms"],
        **{f: rec["graph"]["launches"]["nms"] for f, rec in serving_families.items()}}
    kernels[4]["serving_graph_launches"] = {
        "yolo12n": serving_families["yolo12n"]["graph"]["launches"]["attention"]}
    serve_record = {
        "yolo11n": {"captures": captures11, "kernels_vs_plain": parity11, "graph": graph11,
                    "closed_loop": closed,
                    "open_loop": opened, "max_batch_1": floor, "replay_vs_eager": replay_vs_eager,
                    "launches_in_windows": serve_launches},
        "families": serving_families, "val_max_diff": val_err, "wall_s": serve_s, "card": card}

    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"serving": serve_record}), flush=True)
    print(json.dumps({"train_graph": train_graph_record}), flush=True)
    print(json.dumps({"int8": int8_record}), flush=True)
    print(json.dumps({"export": export_record, "sources": sources_record}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "predict": {
        "imgs_per_s_e2e": len(images) / wall, "host_letterbox_ms_per_img": host_ms,
        "device_ms_per_b32": device_ms, "profiled_device_busy_ms": busy_ms,
        "profiled_wall_ms": prof_wall_ms, "card": card}, "train": train_record,
        "trainer": trainer_record, "families": family_record, "dp": dp_record,
        "app": app_record, "tp": tp_record, "phase40": finish_record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

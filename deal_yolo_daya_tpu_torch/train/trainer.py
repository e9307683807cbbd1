"""The training step, the state it carries, and the Trainer around it, for
every family and scale of the registry (yolo11, yolov8, yolo12; n to x).

Counterpart of ``deal_yolo_daya_tpu/train/trainer.py``.

``TrainState.step`` is the train step of ``Trainer._build_steps``: a u8
(B, S, S, 3) batch and padded GT on the model's device go through the
training forward (bf16 compute over f32 parameters under ``amp``), the
detection loss, the backward, the optimizer update and the EMA update. The
loss parts are summed into device tensors: a step reads nothing back. With
``fold_input_div`` the step feeds raw 0..255 images and scales the stem
kernel by 1/255 inside the differentiated function, so the gradient with
respect to the stored kernel is the JAX package's.

``Trainer`` drives it as the JAX Trainer does: the dataset and loaders, the
on-card augmentation (``train/device_augment.py``) with the per-step seed
``(seed << 20) + epoch * 16384 + step``, the dataset held on the card
(``cache="device"``), validation with the EMA weights after each epoch,
``results.csv`` and ``args.yaml``, ``weights/{last,best,epochN}.pt`` and
resume, and the JAX Trainer's options on one device:

- ``steps_per_dispatch``: with the device cache, K steps a dispatch, each
  a replay of one CUDA graph of the whole iteration (``train/step_graph.py``,
  the counterpart of the chunked ``lax.scan``); None resolves as in JAX, and
  the epoch's remainder and the profiled epoch run eagerly;
- ``device_augment=False``: the host augmentation (``train/augment.py``)
  in the loader's worker threads, streamed. ``device_augment=None``
  augments on the card, where the JAX package picks the host on machines
  of more than 2 cores: this port's card machines have no cv2, and the
  host augmentation in numpy is the slower;
- ``remat``, ``profile_steps`` (a ``torch.profiler`` Chrome trace of steps
  1..N of the first epoch under ``<run>/profile``), ``async_ckpt``
  (``train/async_ckpt.py``) and ``batch=-1`` (``train/autobatch.py``).

``device`` takes the JAX grammar (``parallel/mesh.py::mesh_from_spec``):
"" every card, "N" the first N, "2x4@dcn" two hosts of four, plus "cpu"
and "0" (the first card). With D > 1 cards on the data axis the Trainer is
data parallel, one rank a card (``parallel/launch.py``), and computes what
the JAX Trainer computes on a D-device mesh: ``batch`` is the global batch
(rounded down to a multiple of D), each rank takes its B / D rows of it,
and the step is the one-device step of the global batch
(``TrainState.attach``). The device cache is split by rows over the ranks
(``DataLoader.sharded_epoch_indices``); the streamed path loads each rank's
rows; the on-card augmentation draws for the global batch. Rank 0 alone
validates, writes the run directory, ``results.csv`` and the checkpoints,
and decides the early stops for every rank. A Trainer made in a plain
process starts the other ranks itself and is rank 0; in a process of a
``torchrun`` or of ``init_distributed``'s cluster it is that rank. A model
axis above 1 (tensor parallelism) is not ported yet (ROADMAP.md).

The plots are not ported (ROADMAP.md). ``donate`` and ``fold_div_barrier``
are accepted and have no counterpart: PyTorch frees buffers itself, and the
barrier works around an XLA compiler fault.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from ..parallel import launch
from ..parallel.mesh import mesh_from_spec
from ..parallel.sharding import tp_param_shardings
from ..models.registry import FAMILIES, infer_arch, make_detector, parse_model_spec
from ..models.torch_import import import_state_dict, read_torch_checkpoint
from ..models.yolo11 import init_weights
from ..ops.decode import decode_predictions
from ..ops.nms import batched_nms
from .artifacts import RunDir
from .async_ckpt import CheckpointWriter, snapshot
from .augment import AugmentConfig
from .autobatch import suggest_batch
from .data import DataLoader, Prefetcher, YoloDataset
from .device_augment import DeviceAugConfig, augment_batch, step_seed
from .step_graph import StepProgram, auto_steps_per_dispatch
from .loss import LossConfig, detection_loss
from .metrics import DetMetrics
from .optimizer import (H_EMA_DECAY, H_GRAD_KEEP, N_HYPER, Optimizer, OptimizerConfig,
                        accumulate_gradients, ema_decay, ema_update, lr_schedule)

STEM_KERNEL = "0.conv.weight"
LOSS_PARTS = ("box_loss", "cls_loss", "dfl_loss", "num_fg")
CHECKPOINT_FORMAT = "deal_yolo_daya_tpu_torch/trainer-checkpoint-1"


@dataclass
class TrainConfig:
    """The JAX ``TrainConfig``'s fields, names and defaults."""
    model: str = "yolo11n"
    data: str = ""
    epochs: int = 100
    imgsz: int = 640
    batch: int = 16             # -1: the largest that fits (train/autobatch.py)
    auto_batch_bytes: int = 0   # for batch=-1
    device: str = ""            # "" all cards, "N", "AxB", "2x4@dcn"; "0" the first; "cpu"
    amp: bool = True
    optimizer: str = "auto"
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    seed: int = 0
    patience: int = 100
    cos_lr: bool = False
    close_mosaic: int = 10
    save_period: int = -1
    project: str = "runs/train"
    name: str = "train"
    exist_ok: bool = False
    resume: Any = False         # True: <run>/weights/last.pt, or a checkpoint path
    workers: int = 3            # prefetch depth
    # None (auto: "device") | False | True (decoded images in host RAM) |
    # "device" (the whole train set on the card, batches gathered there;
    # falls back to streaming when over extra["cache_budget_gb"], default 8)
    cache: Any = None
    val: bool = True
    val_period: int = 1         # validate every K epochs (and the last)
    time_phases: bool = False   # print each epoch's phase times
    max_boxes: int = 128
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    mosaic: float = 1.0
    mixup: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0
    bgr: float = 0.0
    scale: float = 0.5
    translate: float = 0.1
    degrees: float = 0.0
    shear: float = 0.0
    conf: float = 0.001         # validation confidence threshold
    iou: float = 0.7            # validation NMS IoU threshold
    max_det: int = 300
    donate: bool = False        # no counterpart (XLA buffer donation)
    # None (auto) and True: augment on the card; False: on the host
    # (train/augment.py), streamed
    device_augment: Optional[bool] = None
    profile_steps: int = 0      # > 0: a torch.profiler trace of steps 1..N into <run>/profile
    remat: bool = False         # recompute the heavy blocks in the backward
    fold_input_div: bool = True
    fold_div_barrier: Optional[bool] = None  # no counterpart (an XLA workaround)
    # device cache only: K steps a dispatch as CUDA graph replays; None:
    # the largest K in [4, 16] dividing the epoch's batches, else 8; 1: eager
    steps_per_dispatch: Optional[int] = None
    loss_batch_scale: bool = False
    # nominal batch: > 0 sums round(nbs / batch) micro-batch gradients a
    # step and scales weight decay by batch * accumulate / nbs
    nbs: int = 0
    single_cls: bool = False
    save_json: bool = False     # predictions.json at validation
    time: float = 0.0           # wall-clock budget in hours (0: none)
    fraction: float = 1.0       # train on the leading fraction of the set
    # freeze the first N modules (ultralytics indices; the head never):
    # no gradients, no updates, BN running statistics still move
    freeze: int = 0
    async_ckpt: bool = True     # checkpoints written by a background thread
    keep_last: int = 5          # newest epochN checkpoints kept (<= 0: all)
    extra: Dict[str, Any] = field(default_factory=dict)


def fitness(metrics: Dict[str, float]) -> float:
    return 0.1 * metrics.get("map50", 0.0) + 0.9 * metrics.get("map", 0.0)


def bucket_gt(gt_boxes, gt_classes, gt_mask, max_boxes: int, min_bucket: int = 4):
    """Trim padded GT arrays to the batch's largest count, rounded up to a
    power of two (at least ``min_bucket``, at most ``max_boxes``). The
    (B, N, A) assigner tensors scale with N. Runs on the host arrays (numpy
    or CPU tensors) before they go to the card: it reads the count."""
    n_max = int(gt_mask.sum(1).max()) if len(gt_mask) else 0
    bucket = min_bucket
    while bucket < n_max:
        bucket <<= 1
    bucket = min(bucket, max_boxes)
    return gt_boxes[:, :bucket], gt_classes[:, :bucket], gt_mask[:, :bucket]


def frozen_modules(freeze: int, family: str = "yolo11") -> tuple:
    """The names of the family's modules ``freeze=N`` freezes: the indices
    below N but the detect head's, which is never frozen."""
    detect = str(FAMILIES[family].DETECT)
    return tuple(str(i) for i in range(int(freeze)) if str(i) != detect)


class TrainState:
    """Model, optimizer, parameter EMA and update count of one training run,
    with the train step as ``step(...)``.

    ``accumulate`` sums that many micro-batch gradients an update (the EMA
    then moves once an update); ``frozen`` names top-level modules that get
    no gradients and no updates; ``family`` and ``scale`` name the detector
    (by default those of ``cfg.model``); ``cfg.remat`` recomputes the heavy
    blocks' activations in the backward.

    A step is ``next_hyper()`` on the host (the schedules' values for the
    next micro-batch copied into the device vector ``hyper``, and the
    counts), then ``iteration(...)`` on the device, which reads them from
    ``hyper``. The CUDA graph of ``train/step_graph.py`` captures
    ``iteration`` as it is.

    ``attach(dp)`` makes it one rank of a data-parallel group
    (``parallel.DataParallel``): a step then takes this rank's rows of the
    global batch and computes the one-process step of the global batch, as
    the JAX step under a sharded mesh: BatchNorm over the global batch, the
    loss over the global target-score sum, and the gradients summed over the
    ranks (one all-reduce of the flat gradient buffer an update).

    >>> state = TrainState(TrainConfig(), nc=80, steps_per_epoch=100)  # on the card
    >>> total = state.step(images_u8, gt_boxes, gt_classes, gt_mask)
    """

    def __init__(self, cfg: TrainConfig, nc: int, steps_per_epoch: int, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None, accumulate: int = 1,
                 frozen: Sequence[str] = (), family: Optional[str] = None,
                 scale: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # without amp the parameters' dtype (f32 unless the default dtype is
        # changed: the tests' float64 comparisons)
        self.dtype = torch.bfloat16 if cfg.amp else torch.get_default_dtype()
        self.family, self.scale = parse_model_spec(cfg.model) if family is None \
            else (family, scale)
        model = init_weights(make_detector(self.family, self.scale, nc, remat=cfg.remat),
                             cfg.seed)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        for name, mod in model.named_children():
            if name in frozen:
                mod.requires_grad_(False)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model.to(self.device).train()
        self.loss_cfg = LossConfig(nc=nc, box_gain=cfg.box, cls_gain=cfg.cls,
                                   dfl_gain=cfg.dfl, batch_scale=cfg.loss_batch_scale)
        self.opt_cfg = opt_cfg or OptimizerConfig(
            name=cfg.optimizer, lr0=cfg.lr0, lrf=cfg.lrf, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, warmup_epochs=cfg.warmup_epochs,
            cos_lr=cfg.cos_lr, epochs=cfg.epochs, steps_per_epoch=steps_per_epoch)
        self.optimizer = accumulate_gradients(accumulate, Optimizer(self.opt_cfg, self.model),
                                              mean=not cfg.loss_batch_scale)
        self.params = [p.detach() for p in self.model.parameters()]
        self.ema = [p.clone() for p in self.params]
        self.updates = 0  # micro-batch steps taken (the JAX state.step)
        self.loss_acc = {k: torch.zeros((), device=self.device) for k in LOSS_PARTS}
        self.hyper = torch.zeros(N_HYPER, device=self.device)
        self.dp = None

    def attach(self, dp) -> None:
        """Join the data-parallel group ``dp``: every BatchNorm synchronises
        over it, the gradients move into one flat buffer, and rank 0's
        parameters, statistics, EMA and optimizer state are copied to every
        rank."""
        self.dp = dp
        for mod in self.model.modules():
            if hasattr(mod, "update_stats"):  # models.blocks.BatchNorm
                mod.dp = dp
        self.flat_grad = self.optimizer.inner.flatten_grads()
        views = self.state_views()
        tensors = [*views["model"].values(), *views["ema"].values(), *self.optimizer.inner.grads(),
                   *[t for st in views["optimizer"]["optimizer"]["state"].values()
                     for t in st.values()]]
        dp.broadcast_(tensors)

    def detach(self) -> None:
        """Leave the data-parallel group: the one-device step again."""
        self.dp = None
        for mod in self.model.modules():
            if hasattr(mod, "update_stats"):
                mod.dp = None

    def zero_loss_acc(self) -> None:
        """Set the loss sums to 0, in place (a captured step adds into them)."""
        for v in self.loss_acc.values():
            v.zero_()

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters under the model's state-dict names."""
        return {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema)}

    def _apply(self, images: torch.Tensor, params: Dict[str, torch.Tensor]):
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view of the NHWC batch
        params = dict(params)
        if self.cfg.fold_input_div:
            params[STEM_KERNEL] = params.get(
                STEM_KERNEL, self.model.get_parameter(STEM_KERNEL)) * (1.0 / 255.0)
        else:
            x = x / 255.0
        # no cast cache: a CUDA graph must not keep casts across its capture
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.cfg.amp,
                            cache_enabled=False):
            return functional_call(self.model, params, (x,))

    def forward(self, images: torch.Tensor):
        """The training forward of a u8 (B, S, S, 3) batch -> per-level
        (box, cls) head outputs, in bf16 under ``amp``."""
        return self._apply(images, {})

    @torch.no_grad()
    def eval_forward(self, images: torch.Tensor, use_ema: bool = True):
        """The forward of validation: eval mode (running statistics), the EMA
        parameters (or the live ones), unfused."""
        self.model.eval()
        try:
            return self._apply(images, self.ema_state_dict() if use_ema else {})
        finally:
            self.model.train()

    def loss(self, images: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             gt_mask: torch.Tensor):
        """The training forward and the detection loss -> (total, parts)."""
        box, cls = self.forward(images)
        # the loss runs outside autocast: its dtypes are its own
        return detection_loss(box, cls, gt_classes, gt_boxes, gt_mask,
                              (self.cfg.imgsz, self.cfg.imgsz), self.loss_cfg, self.dp)

    def next_hyper(self) -> bool:
        """Copy the next micro-batch's row into ``hyper`` (a pinned copy on
        the current stream) and count it (``updates`` and the optimizer's
        counts) -> whether it applies the update."""
        acc = self.optimizer
        keep, update = acc.window()
        row = [0.0] * N_HYPER
        row[H_GRAD_KEEP], row[H_EMA_DECAY] = keep, 1.0
        if update:
            for col, v in acc.inner.hyper_row(acc.updates).items():
                row[col] = v
            row[H_EMA_DECAY] = ema_decay(acc.updates + 1)
        acc.advance()
        self.updates += 1
        self.hyper.copy_(torch.tensor(row, pin_memory=self.device.type == "cuda"),
                         non_blocking=True)
        return update

    def iteration(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, gt_mask: torch.Tensor, update: bool) -> torch.Tensor:
        """One micro-batch on the device with the values in ``hyper``: clear
        or keep the summed gradients, forward, loss, backward, and with
        ``update`` the optimizer and the EMA; the loss parts are added to
        ``loss_acc``. No host read. Returns the total loss."""
        grads = self.optimizer.inner.grads()
        torch._foreach_mul_(grads, self.hyper[H_GRAD_KEEP])
        total, parts = self.loss(images, gt_boxes, gt_classes, gt_mask)
        total.backward()
        if update:
            if self.dp is not None:  # the global batch's gradient: SUM over the ranks
                self.dp.all_reduce_(self.flat_grad)
            self.optimizer.apply(self.hyper)
            ema_update(self.ema, self.params, self.hyper[H_EMA_DECAY])
        with torch.no_grad():
            for k in LOSS_PARTS:
                self.loss_acc[k].add_(parts[k].detach())
        return total.detach()

    def step(self, images: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             gt_mask: torch.Tensor) -> torch.Tensor:
        """One micro-batch on a u8 (B, S, S, 3) batch with padded GT (B, N, 4)
        xyxy pixels, (B, N) classes and (B, N) bool mask; the update at the
        end of each accumulation window (every step by default). Returns the
        total loss as a device tensor; the parts are added to ``loss_acc``.
        Without accumulation each parameter's ``.grad`` then holds this
        step's gradient."""
        return self.iteration(images, gt_boxes, gt_classes, gt_mask, self.next_hyper())

    def state_views(self) -> Dict[str, Any]:
        """What ``state()`` holds, as the live tensors on the device."""
        return {"model": {k: v.detach() for k, v in self.model.state_dict().items()},
                "ema": self.ema_state_dict(), "optimizer": self.optimizer.state_dict(),
                "updates": self.updates}

    def state(self) -> Dict[str, Any]:
        """Parameters and BN statistics and EMA, the optimizer's state and
        the count, copied to the host."""
        return to_host(self.state_views())

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore what ``state()`` returned, in place."""
        self.model.load_state_dict(state["model"], strict=True)
        ema = state["ema"]
        with torch.no_grad():
            for (name, _), e in zip(self.model.named_parameters(), self.ema):
                e.copy_(ema[name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.updates = int(state["updates"])


def to_host(obj):
    """A nest of dicts, lists and tensors with every tensor copied to the host."""
    return snapshot(obj, lambda t: t.detach().cpu() if t.device.type != "cpu"
                    else t.detach().clone())


class ForeignCheckpoint(ValueError):
    """A .pt that the port's Trainer did not write (an ultralytics one goes
    through ``models/torch_import.py``)."""


def load_checkpoint(path) -> Dict[str, Any]:
    """A checkpoint the port's Trainer wrote, on the host; raises
    ForeignCheckpoint for any other file."""
    try:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # pickled classes: not this Trainer's format
        ckpt = None
    if not isinstance(ckpt, dict) or ckpt.get("format") != CHECKPOINT_FORMAT:
        raise ForeignCheckpoint(f"{path}: not a checkpoint of this package's Trainer")
    return ckpt


def checkpoint_family(ckpt: Dict[str, Any]) -> str:
    """The family a checkpoint records; yolo11 for checkpoints written
    before the registry, which record none."""
    return ckpt.get("family", "yolo11")


def inference_state_dict(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The weights validation and predict use: the EMA parameters with the
    live BN statistics."""
    return {**ckpt["model"], **ckpt["ema"]}


def _train_rank(dp, cfg: "TrainConfig") -> None:
    """A spawned rank of a data-parallel Trainer (``parallel/launch.py``)."""
    Trainer(cfg).train()


class Trainer:
    """Train a detector of any family on a YOLO-layout dataset.

    >>> Trainer(TrainConfig(model="yolo11n", data="data.yaml", epochs=10)).train()

    ``init_state_dict`` (the JAX ``init_variables``) starts from those
    weights where their shapes fit, and from the fresh init elsewhere (a
    class head under another nc; the JAX ``_apply_pretrained``, reported in
    ``import_report``). ``model="<run>/weights/best.pt"`` does the same from
    a checkpoint of this Trainer, and ``model="<ultralytics>.pt"`` from an
    ultralytics checkpoint (``models/torch_import.py``), the architecture
    taken from either; explicit ``init_state_dict`` wins over both (on a
    data-parallel run rank 0's weights reach every rank).

    ``extra["dist_timeout_s"]`` bounds a wait in a collective of a
    data-parallel run (default 1800 s): the other ranks wait there while
    rank 0 validates."""

    def __init__(self, config: TrainConfig,
                 init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 eval_apply: Optional[Callable[[torch.Tensor], Any]] = None):
        self.cfg = cfg = config
        # validation's forward in place of the EMA model's: a u8 (B, S, S, 3)
        # batch -> per-level (box, cls), e.g. the int8 model (api.val)
        self._eval_apply = eval_apply
        self._ranks = None
        self.dp = self._join_ranks(dataclasses.replace(cfg, extra=dict(cfg.extra)))
        self.rank = self.dp.rank if self.dp is not None else 0
        try:
            self._setup(init_state_dict)
        except BaseException:
            self.close(failed=True)
            raise

    def _setup(self, init_state_dict) -> None:
        cfg = self.cfg
        self._dev_cache = None
        self._dev_cache_failed = False
        self._val_staged = None
        self._program: Optional[StepProgram] = None
        self._writer = CheckpointWriter()
        self.import_report: Optional[Dict[str, Any]] = None
        init, source = init_state_dict, "the given weights"
        if str(cfg.model).endswith(".pt"):
            if not Path(cfg.model).exists():
                raise FileNotFoundError(f"model weights not found: {cfg.model}")
            try:
                ckpt = load_checkpoint(cfg.model)
            except ForeignCheckpoint:  # an ultralytics .pt
                spec_weights, _ = read_torch_checkpoint(cfg.model)
                self.family, self.scale = infer_arch(spec_weights)  # ValueError: no detector
            else:
                spec_weights = inference_state_dict(ckpt)
                self.family, self.scale = checkpoint_family(ckpt), ckpt["scale"]
            if init is None:  # explicit weights win over the spec's
                init, source = spec_weights, cfg.model
        else:
            self.family, self.scale = parse_model_spec(cfg.model)

        self.train_ds = YoloDataset.from_yaml(cfg.data, "train")
        self.val_ds = YoloDataset.from_yaml(cfg.data, "val")
        if cfg.cache and cfg.cache != "device":
            self.train_ds.enable_cache()
            self.val_ds.enable_cache()
        if len(self.val_ds) == 0:
            self.val_ds = self.train_ds
        if cfg.fraction < 1.0:
            n = max(1, round(len(self.train_ds) * cfg.fraction))
            self.train_ds.images = self.train_ds.images[:n]
            self.train_ds.labels = self.train_ds.labels[:n]
        if cfg.single_cls:
            for ds in {id(d): d for d in (self.train_ds, self.val_ds)}.values():
                ds.labels = [np.concatenate([np.zeros_like(lab[:, :1]), lab[:, 1:]], axis=1)
                             if len(lab) else lab for lab in ds.labels]
                ds.names = ["item"]
        self.nc = max(self.train_ds.nc, 1)
        self.names = self.train_ds.names or [str(i) for i in range(self.nc)]

        n_data = self.n_data
        if cfg.batch > 0 and cfg.batch % n_data:
            cfg.batch = max(n_data, cfg.batch // n_data * n_data)
        if cfg.device_augment is None:  # the card (see the module docstring)
            cfg.device_augment = True
        if cfg.cache is None:  # the JAX rule: the device cache on one device only
            cfg.cache = "device" if cfg.device_augment and n_data == 1 else False
        if cfg.batch < 0:
            # the per-card batch, probed on rank 0's card, times D
            on_card = cfg.cache == "device" and cfg.device_augment
            cached = self._device_cache_bytes() / n_data if on_card else 0  # a card's shard
            cached = 0 if cached > self._cache_budget() else cached
            per_card = self._decide(lambda: suggest_batch(
                lambda: TrainState(cfg, self.nc, 100, device=self.device, family=self.family,
                                   scale=self.scale),
                cfg.imgsz, self.device, max_boxes=cfg.max_boxes,
                limit_bytes=cfg.auto_batch_bytes or None, reserve_bytes=cached,
                graphed=bool(cached) and self.steps_per_dispatch(1) != 1,
                evaluate=lambda st, *batch: self.eval_step(*batch, state=st)))
            cfg.batch = n_data * per_card
        self.aug_cfg = DeviceAugConfig(
            mosaic=cfg.mosaic, mixup=cfg.mixup, scale=cfg.scale, translate=cfg.translate,
            degrees=cfg.degrees, shear=cfg.shear, hsv_h=cfg.hsv_h, hsv_s=cfg.hsv_s,
            hsv_v=cfg.hsv_v, fliplr=cfg.fliplr, flipud=cfg.flipud, bgr=cfg.bgr)
        if max(abs(cfg.degrees), abs(cfg.shear)) > 45.0:
            print("degrees/shear above 45: the on-card augmentation samples every pixel "
                  "by gather (the slow path)")
        self.train_loader = DataLoader(
            self.train_ds, cfg.batch, cfg.imgsz, augment=True, seed=cfg.seed,
            max_boxes=cfg.max_boxes, aug_config=AugmentConfig(
                mosaic=cfg.mosaic, mixup=cfg.mixup, hsv_h=cfg.hsv_h, hsv_s=cfg.hsv_s,
                hsv_v=cfg.hsv_v, fliplr=cfg.fliplr, flipud=cfg.flipud, scale=cfg.scale,
                translate=cfg.translate, degrees=cfg.degrees, shear=cfg.shear, bgr=cfg.bgr))
        self.val_loader = DataLoader(self.val_ds, cfg.batch, cfg.imgsz, augment=False,
                                     seed=cfg.seed, max_boxes=cfg.max_boxes, keep_meta=True,
                                     shuffle=False, drop_last=False)

        steps_per_epoch = max(len(self.train_loader), 1)
        eff_wd = cfg.weight_decay
        self.accumulate = 1
        if cfg.nbs:
            self.accumulate = max(round(cfg.nbs / cfg.batch), 1)
            total_steps = steps_per_epoch * max(cfg.epochs, 1)
            if self.accumulate > total_steps:
                # a window longer than the run would never apply an update
                print(f"nbs={cfg.nbs}: accumulation window {self.accumulate} exceeds the "
                      f"run's {total_steps} steps; cut to {total_steps}")
                self.accumulate = total_steps
            eff_wd = cfg.weight_decay * cfg.batch * self.accumulate / cfg.nbs
        self.opt_cfg = OptimizerConfig(
            name=cfg.optimizer, lr0=cfg.lr0, lrf=cfg.lrf, momentum=cfg.momentum,
            weight_decay=eff_wd, warmup_epochs=cfg.warmup_epochs, cos_lr=cfg.cos_lr,
            epochs=cfg.epochs, steps_per_epoch=max(steps_per_epoch // self.accumulate, 1))
        self.lr_fn = lr_schedule(self.opt_cfg)
        self.lr_fn_bias = lr_schedule(self.opt_cfg, warmup_start=self.opt_cfg.warmup_bias_lr)

        # rank 0 makes the run directory (the auto-increment) and writes
        # args.yaml; the other ranks take its path
        path = self._decide(lambda: str(RunDir(cfg.project, cfg.name, cfg.exist_ok).path))
        self.run = RunDir.at(path)
        if self.rank == 0:
            self.run.write_args({**dataclasses.asdict(cfg), "family": self.family})

        self.frozen = frozen_modules(cfg.freeze, self.family)
        self.state = TrainState(
            cfg, self.nc, steps_per_epoch, device=self.device,
            state_dict=None if init is None else self._overlay(init, source),
            opt_cfg=self.opt_cfg, accumulate=self.accumulate, frozen=self.frozen,
            family=self.family, scale=self.scale)
        self.start_epoch = 0
        if cfg.resume:
            self._try_resume()  # every rank reads the same file
        if self.dp is not None:
            self.state.attach(self.dp)  # rank 0's state on every rank

    # ------------------------------------------------------------------ ranks

    def _join_ranks(self, cfg: TrainConfig):
        """The mesh of ``cfg.device`` -> this process's ``DataParallel``, or
        None on one device (``self.device`` set either way). A plain process
        asked for D > 1 devices starts the other ranks of its host here, each
        running ``Trainer(cfg).train()`` on the config as given."""
        spec = str(cfg.device or "")
        self.mesh = mesh = mesh_from_spec(spec or None)
        tp_param_shardings(None, mesh)  # a model axis above 1 raises: not ported
        self.n_data = mesh.shape["data"]
        if mesh.size == 0:  # no card: never the CPU unless asked for
            self.device = resolve_device("cuda")
        if self.n_data <= 1:  # the first device: "cuda" (the current card) or the CPU
            self.device = resolve_device(mesh.devices.reshape(-1)[0].torch_device.type)
            return None
        dp = launch.current()
        if dp is None:
            self._ranks = launch.start(mesh, _train_rank, (cfg,), timeout_s=float(
                cfg.extra.get("dist_timeout_s", launch.DEFAULT_TIMEOUT_S)))
            dp = self._ranks.dp
        if dp.world != self.n_data:
            raise ValueError(f"device={spec!r} asks for {self.n_data} ranks; this process's "
                             f"group has {dp.world}")
        self.device = dp.device
        return dp

    def _decide(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` on rank 0, its value on every rank."""
        if self.dp is None:
            return fn()
        return self.dp.decide(fn() if self.rank == 0 else None)

    def close(self, failed: bool = False) -> None:
        """End the data-parallel run this Trainer started (leave the group,
        wait for the other ranks; a rank that failed raises ``WorkerError``).
        ``train()`` calls it; nothing to do on one device."""
        state = getattr(self, "state", None)
        if state is not None:
            state.detach()
        ranks, self._ranks = self._ranks, None
        if ranks is not None:
            ranks.close(failed)

    def _overlay(self, init: Dict[str, Any], source: str) -> Dict[str, torch.Tensor]:
        """``init`` (ultralytics keys: the given weights, a checkpoint's or an
        ultralytics .pt's) laid over a fresh init by ``import_state_dict``
        with ``strict=False``: a tensor of another shape (the class head
        under another nc) keeps the fresh init. The report is logged and
        kept in ``import_report``."""
        fresh = init_weights(make_detector(self.family, self.scale, self.nc), self.cfg.seed)
        state_dict, self.import_report = import_state_dict(init, fresh, strict=False)
        mismatched = len(self.import_report["shape_mismatch"])
        print(f"imported {self.import_report['imported']} tensors of {source}"
              + (f" ({mismatched} of another shape keep the fresh init)" if mismatched else ""))
        return state_dict

    # ------------------------------------------------------------------ cache

    def _ensure_device_cache(self):
        """The whole train set on the device once: canvases, (h, w) and
        padded GT. Every epoch then gathers its batches there; the only
        upload a step is the (B,) index. None when over budget.

        Under data parallelism the rows are split over the ranks, as the
        JAX Trainer shards them over its data axis: rank d holds rows
        d * ceil(n / D) on (the budget is a card's), and each epoch's
        indices are local to that shard (``sharded_epoch_indices``)."""
        if self._dev_cache is not None or self._dev_cache_failed:
            return self._dev_cache
        dl = self.train_loader
        n, n_data = len(dl.ds), self.n_data
        need, budget = self._device_cache_bytes(), self._cache_budget()
        shard_n = -(-n // n_data)
        # every shard must be able to supply its rank's rows of a batch
        feasible = min(shard_n, n - (n_data - 1) * shard_n) >= self.cfg.batch // n_data
        if n == 0 or need / n_data > budget or not feasible:
            print(f"cache=device needs about {need / n_data / 1e9:.1f} GB a card (budget "
                  f"{budget / 1e9:.1f} GB)" + ("" if feasible else ", and a shard smaller "
                                              "than a rank's rows of a batch")
                  + "; streaming instead")
            self._dev_cache_failed = True
            return None
        t0 = time.time()
        first = self.rank * shard_n
        stop = min(first + shard_n, n)
        parts, offset = None, 0
        for chunk in dl.raw_chunks(first=first, stop=stop):
            if parts is None:
                parts = tuple(torch.empty((stop - first,) + a.shape[1:],
                                          dtype=torch.from_numpy(a).dtype, device=self.device)
                              for a in chunk)
            for buf, a in zip(parts, chunk):
                buf[offset:offset + len(a)].copy_(torch.from_numpy(a))
            offset += len(chunk[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.cache_build_s = time.time() - t0
        print(f"train set on the device: {stop - first} of {n} images (~"
              f"{need / n_data / 1e9:.2f} GB, {self.cache_build_s:.1f} s)")
        self._dev_cache = parts
        return parts

    def _device_cache_bytes(self) -> int:
        """The bytes of the train set on the device, and of the val batches
        kept there."""
        per_img = self.cfg.imgsz * self.cfg.imgsz * 3 + self.cfg.max_boxes * 24 + 16
        return (len(self.train_ds) + len(self.val_ds)) * per_img

    def _cache_budget(self) -> float:
        return float(self.cfg.extra.get("cache_budget_gb", 8.0)) * 1e9

    def _to_device(self, arrays):
        pin = self.device.type == "cuda"
        return tuple((torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a))
                     .to(self.device, non_blocking=pin) for a in arrays)

    # ------------------------------------------------------------------ ckpt

    def _ckpt_dir(self) -> Path:
        return (self.run.path / "weights").resolve()

    def checkpoint(self, epoch: int, fit: float) -> Dict[str, Any]:
        return to_host(self.checkpoint_views(epoch, fit))

    def checkpoint_views(self, epoch: int, fit: float) -> Dict[str, Any]:
        """``checkpoint()`` with the live device tensors in place of copies."""
        return {**self.state.state_views(), "format": CHECKPOINT_FORMAT, "epoch": epoch,
                "fitness": fit, "nc": self.nc, "names": list(self.names),
                "family": self.family, "scale": self.scale, "imgsz": self.cfg.imgsz,
                "train_args": json.loads(json.dumps(dataclasses.asdict(self.cfg), default=str))}

    def save_checkpoint(self, tag: str, epoch: int, fit: float):
        """weights/<tag>.pt, written whole or not at all: by the background
        writer under ``async_ckpt`` (an error is raised by the next
        ``flush_checkpoints``), else here."""
        path = self._ckpt_dir() / f"{tag}.pt"
        if self.cfg.async_ckpt:
            self._writer.save(path, self.checkpoint_views(epoch, fit),
                              after=self._gc_epoch_checkpoints)
            return
        tmp = path.with_suffix(".pt.tmp")
        torch.save(self.checkpoint(epoch, fit), tmp)
        os.replace(tmp, path)
        self._gc_epoch_checkpoints()

    def flush_checkpoints(self) -> None:
        """Wait for the background writes; raise the first error one met."""
        self._writer.flush()

    def _gc_epoch_checkpoints(self):
        """Keep the newest cfg.keep_last epochN checkpoints (last and best stay)."""
        k = self.cfg.keep_last
        if not k or k <= 0:
            return
        epochs = {}
        for p in self._ckpt_dir().glob("epoch*.pt"):
            m = re.fullmatch(r"epoch(\d+)\.pt", p.name)
            if m:
                epochs[int(m.group(1))] = p
        for n in sorted(epochs)[:-k]:
            epochs[n].unlink()

    def _try_resume(self):
        self.flush_checkpoints()
        path = self.cfg.resume
        path = self._ckpt_dir() / "last.pt" if path is True else Path(str(path))
        if not path.exists():
            print(f"resume checkpoint {path} does not exist; training from the start")
            return
        ckpt = load_checkpoint(path)
        self.state.load_state(ckpt)
        self.start_epoch = int(ckpt["epoch"]) + 1
        print(f"resumed from {path} (epoch {self.start_epoch})")

    # ------------------------------------------------------------------ train

    def _aug_now(self) -> DeviceAugConfig:
        """The on-card augmentation of the current epoch (close_mosaic turns
        mosaic and mixup off)."""
        if self.train_loader.mosaic_off:
            return self.aug_cfg._replace(mosaic=0.0, mixup=0.0)
        return self.aug_cfg

    def augment(self, batch, seed: int):
        """The on-card augmentation of one raw batch (on the device); under
        data parallelism this rank's rows of the global batch's."""
        return augment_batch(*batch, seed, self.cfg.imgsz, self._aug_now(),
                             max_boxes=self.cfg.max_boxes, dp=self.dp)

    def _uses_device_cache(self) -> bool:
        return (self.cfg.cache == "device" and bool(self.cfg.device_augment)
                and self._ensure_device_cache() is not None)

    def steps_per_dispatch(self, n_batches: int = 0) -> int:
        """The resolved K (``auto_steps_per_dispatch``; 1 on several
        devices unless given)."""
        return auto_steps_per_dispatch(self.cfg.steps_per_dispatch, n_batches, self.n_data == 1)

    def _epoch_indices(self, epoch: int):
        """The epoch's batches of the device cache: dataset indices, or this
        rank's indices local to its shard."""
        if self.dp is None:
            return list(self.train_loader.epoch_indices(epoch))
        rows = self.dp.rows(self.cfg.batch)
        return [idxs[rows] for idxs in self.train_loader.sharded_epoch_indices(epoch, self.n_data)]

    def step_program(self) -> StepProgram:
        """The step program of the current augmentation; a close_mosaic
        flip replaces it (and frees the old one's graphs)."""
        aug = self._aug_now()
        prog = self._program
        if prog is None or prog.aug_cfg != aug:
            self._program = prog = None
            prog = self._program = StepProgram(self.state, self._dev_cache, aug, self.cfg.imgsz,
                                               self.cfg.max_boxes, self.cfg.batch)
        return prog

    def _epoch_batches(self, epoch: int, first: int = 0):
        """The epoch's batches from its ``first`` on, on the device: raw
        ones for the on-card augmentation (gathered from the device cache,
        or decoded on the host and copied in a background thread), or
        augmented on the host, GT bucketed, copied likewise."""
        cfg = self.cfg
        if self._uses_device_cache():
            cache = self._dev_cache
            for idxs in self._epoch_indices(epoch)[first:]:
                idx = torch.from_numpy(idxs).to(self.device)
                yield tuple(t[idx] for t in cache)
            return
        if first:
            raise ValueError("a streamed epoch starts at its first batch")
        rows = self.dp.rows(cfg.batch) if self.dp is not None else None
        if cfg.device_augment:
            yield from Prefetcher(
                self.train_loader.epoch_raw(epoch, rows=rows), depth=cfg.workers,
                transfer=lambda b: self._to_device((b.images, b.hw, b.gt_boxes, b.gt_classes,
                                                    b.gt_mask)))
            return

        def transfer(b):
            return self._to_device((b.images, *bucket_gt(b.gt_boxes, b.gt_classes, b.gt_mask,
                                                         cfg.max_boxes)))

        yield from Prefetcher(self.train_loader.epoch(epoch, rows=rows), depth=cfg.workers,
                              transfer=transfer)

    def _profile(self, prof=None):
        """Start a torch.profiler trace (no ``prof``), or stop ``prof`` and
        write it to <run>/profile/trace.json."""
        from torch.profiler import ProfilerActivity, profile

        if prof is None:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
            return prof
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.run.path / "profile"
        out.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"profiler trace written to {out / 'trace.json'}")
        return None

    def _train_epoch(self, epoch: int) -> int:
        """One epoch's steps -> their count. With the device cache and K > 1
        (not in a profiled epoch) K steps a dispatch through the step
        program, the remainder eagerly, as the JAX Trainer does."""
        cfg = self.cfg
        n_steps = 0
        # rank 0 alone traces
        profiled = cfg.profile_steps > 0 and epoch == self.start_epoch and self.rank == 0
        if self._uses_device_cache() and not (cfg.profile_steps > 0 and epoch == self.start_epoch):
            all_idx = self._epoch_indices(epoch)
            k = self.steps_per_dispatch(len(all_idx))
            if k > 1:
                prog = self.step_program()
                for c in range(len(all_idx) // k):
                    prog.run(np.stack(all_idx[c * k:(c + 1) * k]),
                             [step_seed(cfg.seed, epoch, c * k + j) for j in range(k)])
                    n_steps += k
        prof = None
        for batch in self._epoch_batches(epoch, n_steps):
            if profiled and n_steps == 1:  # after step 0: its builds stay out of the trace
                prof = self._profile()
            if cfg.device_augment:
                batch = self.augment(batch, step_seed(cfg.seed, epoch, n_steps))
            self.state.step(*batch)
            n_steps += 1
            if prof is not None and n_steps >= 1 + cfg.profile_steps:
                prof = self._profile(prof)
        if prof is not None:  # a short epoch: close the trace
            self._profile(prof)
        return n_steps

    def train(self) -> Dict[str, Any]:
        """Train ``cfg.epochs`` epochs -> {"save_dir", "best_fitness",
        "metrics"} (on rank 0; the other ranks of a data-parallel run return
        the same keys and no metrics). The data-parallel run this Trainer
        started ends with it."""
        try:
            result = self._train()
        except BaseException:
            self.close(failed=True)
            raise
        self.close()
        return result

    def _train(self) -> Dict[str, Any]:
        cfg = self.cfg
        lead = self.rank == 0  # validates, writes, decides
        best_fit, best_epoch = -1.0, -1
        t0 = time.time()
        if lead:
            print(f"training {self.family}{self.scale} nc={self.nc} imgsz={cfg.imgsz} "
                  f"batch={cfg.batch} device={self.device} ranks={self.n_data} "
                  f"epochs={cfg.epochs}")
        for epoch in range(self.start_epoch, cfg.epochs):
            if cfg.close_mosaic and cfg.epochs - epoch <= cfg.close_mosaic:
                self.train_loader.mosaic_off = True
            self.state.zero_loss_acc()
            epoch_t0 = time.time()
            n_steps = self._train_epoch(epoch)
            t_dispatch = time.time()
            losses = {"box_loss": 0.0, "cls_loss": 0.0, "dfl_loss": 0.0}
            if n_steps:  # one read of the device sums an epoch (and one all-reduce)
                sums = torch.stack([self.state.loss_acc[k] for k in losses])
                if self.dp is not None:  # each rank's parts are its share of the global loss
                    self.dp.all_reduce_(sums)
                losses = {k: v / n_steps for k, v in zip(losses, sums.tolist())}
            lr_step = self.state.updates // self.accumulate  # in optimizer steps
            t_stepsync = time.time()

            metrics = {"precision": 0.0, "recall": 0.0, "map50": 0.0, "map": 0.0}
            val_losses = {"box_loss": 0.0, "cls_loss": 0.0, "dfl_loss": 0.0}
            if lead and cfg.val and ((epoch + 1) % max(1, cfg.val_period) == 0
                                     or epoch == cfg.epochs - 1):
                metrics, val_losses = self.validate()
            t_val = time.time()

            fit = fitness(metrics)
            stop = None
            if lead:
                epoch_time = time.time() - epoch_t0
                print(f"Epoch {epoch + 1}/{cfg.epochs}  box {losses['box_loss']:.4f} "
                      f"cls {losses['cls_loss']:.4f} dfl {losses['dfl_loss']:.4f}  "
                      f"mAP50 {metrics['map50']:.4f} mAP50-95 {metrics['map']:.4f}  "
                      f"{n_steps * cfg.batch / max(epoch_time, 1e-9):.1f} img/s")
                lr_now = float(self.lr_fn(lr_step))
                self.run.append_results_row({
                    "epoch": epoch + 1, "time": round(time.time() - t0, 2),
                    "train/box_loss": losses["box_loss"], "train/cls_loss": losses["cls_loss"],
                    "train/dfl_loss": losses["dfl_loss"],
                    "metrics/precision(B)": metrics["precision"],
                    "metrics/recall(B)": metrics["recall"],
                    "metrics/mAP50(B)": metrics["map50"], "metrics/mAP50-95(B)": metrics["map"],
                    "val/box_loss": val_losses["box_loss"],
                    "val/cls_loss": val_losses["cls_loss"],
                    "val/dfl_loss": val_losses["dfl_loss"],
                    # pg0/pg1: weights and BN (one schedule), pg2: biases
                    "lr/pg0": lr_now, "lr/pg1": lr_now,
                    "lr/pg2": float(self.lr_fn_bias(lr_step)),
                })
                self.save_checkpoint("last", epoch, fit)
                if fit > best_fit:
                    self.save_checkpoint("best", epoch, fit)
                if cfg.save_period > 0 and (epoch + 1) % cfg.save_period == 0:
                    self.save_checkpoint(f"epoch{epoch + 1}", epoch, fit)
                if cfg.time_phases:
                    print(f"  phases: dispatch {t_dispatch - epoch_t0:.2f}s  "
                          f"step-sync {t_stepsync - t_dispatch:.2f}s  "
                          f"val {t_val - t_stepsync:.2f}s  tail {time.time() - t_val:.2f}s")
                if fit > best_fit:
                    best_fit, best_epoch = fit, epoch
                if cfg.patience and epoch - best_epoch >= cfg.patience:
                    stop = f"EarlyStopping: no improvement in {cfg.patience} epochs"
                elif cfg.time and (time.time() - t0) > cfg.time * 3600:
                    stop = f"training time limit of {cfg.time} h reached"
            # rank 0's fitness, best epoch and stop hold on every rank
            fit, best_fit, best_epoch, stop = self._decide(
                lambda: (fit, best_fit, best_epoch, stop))
            if stop:
                if lead:
                    print(stop)
                break

        self._program = None  # its graphs' memory pool goes with it
        self._writer.close()
        final_metrics = self.validate()[0] if cfg.val and lead else {}
        if lead:
            print(f"training done in {time.time() - t0:.1f} s; results in {self.run.path}")
        return {"save_dir": self.run.path, "best_fitness": best_fit, "metrics": final_metrics}

    # ------------------------------------------------------------------ val

    def eval_step(self, images, gt_boxes, gt_classes, gt_mask, inv, use_ema: bool = True,
                  state: Optional[TrainState] = None):
        """One validation batch on the device -> (detections (boxes, scores,
        classes, n_det), their boxes in original-image pixels, the GT boxes
        likewise, loss parts). ``inv`` (B, 5) is [r, pad_x, pad_y, w, h].
        ``state`` is the Trainer's unless given (the batch=-1 probe's)."""
        imgsz = (self.cfg.imgsz, self.cfg.imgsz)
        if state is None and self._eval_apply is not None:
            state = self.state
            with torch.no_grad():
                box, cls = self._eval_apply(images)
        else:
            state = self.state if state is None else state
            box, cls = state.eval_forward(images, use_ema)
        _, parts = detection_loss(box, cls, gt_classes, gt_boxes, gt_mask, imgsz, state.loss_cfg)
        boxes, scores = decode_predictions(box, cls, imgsz)
        det = batched_nms(boxes, scores, conf_thres=self.cfg.conf, iou_thres=self.cfg.iou,
                          pre_topk=1000, max_det=self.cfg.max_det)
        pad = torch.stack([inv[:, 1], inv[:, 2], inv[:, 1], inv[:, 2]], -1)[:, None, :]
        lim = torch.stack([inv[:, 3], inv[:, 4], inv[:, 3], inv[:, 4]], -1)[:, None, :]
        scale = inv[:, 0][:, None, None]
        unmap = lambda b: torch.minimum(torch.clamp((b - pad) / scale, min=0.0), lim)  # noqa: E731
        return det, unmap(det[0]), unmap(gt_boxes), parts

    def validate(self, use_ema: bool = True):
        """Validate on the val set -> (metrics, mean val loss parts)."""
        cfg = self.cfg
        det_metrics = DetMetrics(nc=self.nc)
        loss_parts: list = []
        # COCO-format predictions: xywh in original pixels, image_id from the stem
        json_records: Optional[list] = [] if cfg.save_json else None

        def stage(batch):
            # in the Prefetcher's thread: bucketing and the copy to the device
            gtb, gtc, gtm = bucket_gt(batch.gt_boxes, batch.gt_classes, batch.gt_mask,
                                      cfg.max_boxes)
            inv = np.array([[m[2], m[3][0], m[3][1], m[1][1], m[1][0]] for m in batch.meta],
                           np.float32)
            return batch, gtm, self._to_device((batch.images, gtb, gtc, gtm, inv))

        def dispatch(item):
            batch, gtm, args = item
            return (batch, gtm) + self.eval_step(*args, use_ema=use_ema)

        def consume(staged):
            batch, gtm, (_, osc, ocl, nd), pb, gb, parts = staged
            loss_parts.append(parts)
            osc, ocl, nd, pb, gb = (t.cpu().numpy() for t in (osc, ocl, nd, pb, gb))
            for i in range(len(batch.images)):
                n, m = int(nd[i]), gtm[i]
                gcls = batch.gt_classes[i][:len(m)][m]
                det_metrics.update(pb[i, :n], osc[i, :n], ocl[i, :n], gb[i][m], gcls)
                if json_records is not None:
                    stem = Path(batch.meta[i][0]).stem
                    image_id = int(stem) if stem.isdigit() else stem
                    for (x1, y1, x2, y2), s, c in zip(pb[i, :n], osc[i, :n], ocl[i, :n]):
                        json_records.append({
                            "image_id": image_id, "category_id": int(c),
                            "bbox": [round(float(x1), 3), round(float(y1), 3),
                                     round(float(x2 - x1), 3), round(float(y2 - y1), 3)],
                            "score": round(float(s), 5)})

        # one-batch pipeline: the host metrics of batch i overlap the device's
        # work on batch i+1 (the copy to the host in consume() waits for it);
        # the Prefetcher stages batch i+2 meanwhile. With the device cache the
        # staged val batches stay on the device across epochs.
        keep_staged = cfg.cache == "device" and self._dev_cache is not None
        if keep_staged and self._val_staged is not None:
            items = self._val_staged
        else:
            items = Prefetcher(self.val_loader.epoch(0), depth=2, transfer=stage)
            if keep_staged:
                items = self._val_staged = list(items)
        staged = None
        for item in items:
            nxt = dispatch(item)
            if staged is not None:
                consume(staged)
            staged = nxt
        if staged is not None:
            consume(staged)

        val_losses = {"box_loss": 0.0, "cls_loss": 0.0, "dfl_loss": 0.0}
        if loss_parts:  # one read of the device sums a pass
            sums = torch.stack([torch.stack([p[k] for k in val_losses])
                                for p in loss_parts]).sum(0).tolist()
            val_losses = {k: v / len(loss_parts) for k, v in zip(val_losses, sums)}
        result = det_metrics.compute()
        if json_records is not None:
            out = self.run.path / "predictions.json"
            out.write_text(json.dumps(json_records), encoding="utf-8")
            print(f"predictions saved to {out}")
        return result, val_losses


def make_config(model: str, data: str, **kwargs) -> TrainConfig:
    """``TrainConfig`` fields by name, other keys into ``cfg.extra``."""
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    cfg = TrainConfig(model=model, data=data, **{k: v for k, v in kwargs.items() if k in known})
    cfg.extra.update({k: v for k, v in kwargs.items() if k not in known})
    return cfg


def train_run(model: str, data: str, **kwargs) -> Dict[str, Any]:
    """One-call training with ``make_config``'s arguments."""
    return Trainer(make_config(model, data, **kwargs)).train()

"""The yolo11 training step and the state it carries.

Counterpart of the train step of ``deal_yolo_daya_tpu/train/trainer.py``
(``Trainer._build_steps``): one call takes a u8 (B, S, S, 3) batch and padded
GT on the model's device and runs the training forward (bf16 compute with
f32 parameters under ``amp``), the detection loss, the backward, the
optimizer update and the EMA update. The loss parts are summed into device
tensors: a step reads nothing back to the host.

With ``fold_input_div`` the step feeds raw 0..255 images and scales the stem
conv kernel by 1/255 inside the differentiated function, so the gradient with
respect to the stored kernel is the JAX package's.

``TrainState`` holds what the JAX ``TrainState`` holds: the model (parameters
and BatchNorm statistics), the optimizer, the EMA of the parameters and the
number of updates so far. The dataset, loader, validation and checkpoints of
the JAX ``Trainer`` are not here yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.func import functional_call

from ..api import parse_model_spec
from ..device import resolve_device
from ..models.yolo11 import YOLO11, init_weights
from .loss import LossConfig, detection_loss
from .optimizer import Optimizer, OptimizerConfig, ema_update

STEM_KERNEL = "0.conv.weight"
LOSS_PARTS = ("box_loss", "cls_loss", "dfl_loss", "num_fg")


@dataclass
class TrainConfig:
    """The train step's fields of the JAX ``TrainConfig``, under its names
    and defaults."""
    model: str = "yolo11n"
    epochs: int = 100
    imgsz: int = 640
    amp: bool = True
    optimizer: str = "auto"
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    cos_lr: bool = False
    seed: int = 0
    max_boxes: int = 128
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    fold_input_div: bool = True
    loss_batch_scale: bool = False


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


class TrainState:
    """Model, optimizer, parameter EMA and update count of one training run,
    with the train step as ``step(...)``.

    >>> state = TrainState(TrainConfig(), nc=80, steps_per_epoch=100)  # on the card
    >>> total = state.step(images_u8, gt_boxes, gt_classes, gt_mask)
    """

    def __init__(self, cfg: TrainConfig, nc: int, steps_per_epoch: int, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.amp else torch.float32
        model = init_weights(YOLO11(nc=nc, scale=parse_model_spec(cfg.model)), cfg.seed)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model.to(self.device).train()
        self.loss_cfg = LossConfig(nc=nc, box_gain=cfg.box, cls_gain=cfg.cls,
                                   dfl_gain=cfg.dfl, batch_scale=cfg.loss_batch_scale)
        self.opt_cfg = OptimizerConfig(
            name=cfg.optimizer, lr0=cfg.lr0, lrf=cfg.lrf, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, warmup_epochs=cfg.warmup_epochs,
            cos_lr=cfg.cos_lr, epochs=cfg.epochs, steps_per_epoch=steps_per_epoch)
        self.optimizer = Optimizer(self.opt_cfg, self.model)
        self.params = list(self.model.parameters())
        self.ema = [p.detach().clone() for p in self.params]
        self.updates = 0
        self.loss_acc = self.zero_loss_acc()

    def zero_loss_acc(self) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((), device=self.device) for k in LOSS_PARTS}

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters under the model's state-dict names."""
        return {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema)}

    def forward(self, images: torch.Tensor):
        """The training forward of a u8 (B, S, S, 3) batch -> per-level
        (box, cls) head outputs, in bf16 under ``amp``."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view of the NHWC batch
        overrides = {}
        if self.cfg.fold_input_div:
            stem = self.model.get_parameter(STEM_KERNEL)
            overrides[STEM_KERNEL] = stem * (1.0 / 255.0)
        else:
            x = x / 255.0
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.cfg.amp):
            return functional_call(self.model, overrides, (x,))

    def loss(self, images: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             gt_mask: torch.Tensor):
        """The training forward and the detection loss -> (total, parts)."""
        box, cls = self.forward(images)
        # the loss runs outside autocast: its dtypes are its own
        return detection_loss(box, cls, gt_classes, gt_boxes, gt_mask,
                              (self.cfg.imgsz, self.cfg.imgsz), self.loss_cfg)

    def step(self, images: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
             gt_mask: torch.Tensor) -> torch.Tensor:
        """One update on a u8 (B, S, S, 3) batch with padded GT (B, N, 4)
        xyxy pixels, (B, N) classes and (B, N) bool mask. Returns the total
        loss as a device tensor; the parts are added to ``loss_acc``. After
        the call each parameter's ``.grad`` holds this step's gradient."""
        self.optimizer.zero_grad()
        total, parts = self.loss(images, gt_boxes, gt_classes, gt_mask)
        total.backward()
        self.optimizer.step(self.updates)
        self.updates += 1
        ema_update(self.ema, [p.detach() for p in self.params], self.updates)
        with torch.no_grad():
            for k in LOSS_PARTS:
                self.loss_acc[k] += parts[k].detach()
        return total.detach()

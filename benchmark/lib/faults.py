"""Faults planted in the program under test, to show that the comparison
that decides ``correct`` catches them. The benchmark's own runs never use
these; the tests and ``benchmark/calibrate.py`` do. Each is a context
manager that patches the program and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def frozen_state():
    """Every train step returns its state unchanged: no optimizer update,
    no EMA."""
    from deal_yolo_daya_tpu_torch.train import trainer

    orig = trainer.TrainState.iteration

    def iteration(self, images, gt_boxes, gt_classes, gt_mask, update):
        return orig(self, images, gt_boxes, gt_classes, gt_mask, False)

    trainer.TrainState.iteration = iteration
    try:
        yield
    finally:
        trainer.TrainState.iteration = orig


@contextlib.contextmanager
def _conv_group(**attrs):
    """The optimizer's conv-kernel group (its first) with ``attrs`` set."""
    from deal_yolo_daya_tpu_torch.train import optimizer

    orig = optimizer.Optimizer.__init__

    def init(self, cfg, model):
        orig(self, cfg, model)
        for k, v in attrs.items():
            setattr(self.groups[0], k, v)

    optimizer.Optimizer.__init__ = init
    try:
        yield
    finally:
        optimizer.Optimizer.__init__ = orig


def weight_lr_column():
    """The conv kernels step with the bias group's learning rate."""
    from deal_yolo_daya_tpu_torch.train.optimizer import H_LR_BIAS

    return _conv_group(column=H_LR_BIAS)


def no_weight_decay():
    """The conv kernels lose their weight decay."""
    return _conv_group(weight_decay=0.0)


@contextlib.contextmanager
def ema_skips_conv_weights():
    """The EMA leaves the conv kernels where they are."""
    from deal_yolo_daya_tpu_torch.train import trainer

    orig = trainer.ema_update

    def ema_update(ema, params, decay):
        pairs = [(e, p) for e, p in zip(ema, params) if p.dim() != 4]
        orig([e for e, _ in pairs], [p for _, p in pairs], decay)

    trainer.ema_update = ema_update
    try:
        yield
    finally:
        trainer.ema_update = orig


@contextlib.contextmanager
def half_batch():
    """Training: each step sees the first half of its augmented batch, the
    loss a mean over those. Inference: the second half of every device
    batch comes back with no detections."""
    from deal_yolo_daya_tpu_torch import api, serve
    from deal_yolo_daya_tpu_torch.train import trainer

    orig_it, orig_inf = trainer.TrainState.iteration, api.infer_fused

    def iteration(self, images, gt_boxes, gt_classes, gt_mask, update):
        h = max(images.shape[0] // 2, 1)
        return orig_it(self, images[:h], gt_boxes[:h], gt_classes[:h], gt_mask[:h], update)

    def infer_fused(*args, **kwargs):
        boxes, scores, classes, n_det = orig_inf(*args, **kwargs)
        h = max(n_det.shape[0] // 2, 1)
        keep = (torch_arange(n_det) < h).to(n_det.dtype)
        return boxes, scores, classes, n_det * keep

    trainer.TrainState.iteration = iteration
    api.infer_fused = serve.infer_fused = infer_fused
    try:
        yield
    finally:
        trainer.TrainState.iteration = orig_it
        api.infer_fused = serve.infer_fused = orig_inf


@contextlib.contextmanager
def altered_answer():
    """Inference: the first image of every device batch has each of its
    detections' class replaced by the next class id where it is produced."""
    from deal_yolo_daya_tpu_torch import api, serve

    orig = api.infer_fused

    def infer_fused(*args, **kwargs):
        boxes, scores, classes, n_det = orig(*args, **kwargs)
        classes = classes.clone()
        classes[0] = torch_remainder(classes[0] + 1)
        return boxes, scores, classes, n_det

    api.infer_fused = serve.infer_fused = infer_fused
    try:
        yield
    finally:
        api.infer_fused = serve.infer_fused = orig


def torch_remainder(c):
    return c.remainder(80)


def torch_arange(t):
    import torch

    return torch.arange(t.shape[0], device=t.device)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "weight_lr_column": weight_lr_column,
          "no_weight_decay": no_weight_decay, "ema_skips_conv_weights": ema_skips_conv_weights}

"""Optimizer: SGD/Adam with warmup + linear/cosine LR, weight decay on conv
kernels only, a bias group that warms down, and parameter EMA.

Counterpart of ``deal_yolo_daya_tpu/train/optimizer.py``. The JAX package
builds one optax chain; here the same arithmetic is three ``torch.optim``
parameter groups whose ``lr`` (and SGD ``momentum``) the train step sets from
the schedules before every update:

- ``decay``: conv kernels, the only leaves with weight decay;
- ``no_decay``: BatchNorm weights (flax's ``scale``);
- ``bias``: every leaf named ``bias`` (BatchNorm biases and the head's conv
  biases), on the schedule that warms down from ``warmup_bias_lr``.

optax's ``add_decayed_weights`` in front of nesterov SGD is
``torch.optim.SGD(nesterov=True, weight_decay=...)``. The JAX "adamw" chains
``add_decayed_weights`` before ``adam``: coupled L2, which is
``torch.optim.Adam(weight_decay=...)`` and not ``torch.optim.AdamW``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
import torch.nn as nn


@dataclass
class OptimizerConfig:
    name: str = "SGD"            # SGD | auto | Adam | AdamW
    lr0: float = 0.01
    lrf: float = 0.01            # final LR fraction
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_bias_lr: float = 0.1      # the bias group warms down from here
    warmup_momentum: float = 0.8     # SGD momentum ramps from here to momentum
    cos_lr: bool = False
    epochs: int = 100
    steps_per_epoch: int = 100


def lr_schedule(cfg: OptimizerConfig, warmup_start: float = 0.0) -> Callable[[int], float]:
    """Step -> lr: warmup (linear from ``warmup_start`` toward the decayed
    value, not toward lr0) then linear or cosine decay to ``lr0 * lrf``.
    ``warmup_epochs <= 0`` means no warmup."""
    warmup_steps = int(cfg.warmup_epochs * cfg.steps_per_epoch)
    total_steps = max(cfg.epochs * cfg.steps_per_epoch, warmup_steps + 1)

    def decay_at(step: float) -> float:
        frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        if cfg.cos_lr:
            return cfg.lrf + (1 - cfg.lrf) * 0.5 * (1 + math.cos(math.pi * frac))
        return 1.0 - (1.0 - cfg.lrf) * frac

    def schedule(step: int) -> float:
        target = cfg.lr0 * decay_at(float(step))
        if step >= warmup_steps:
            return target
        t = min(max(step / warmup_steps, 0.0), 1.0)
        return warmup_start + (target - warmup_start) * t

    return schedule


def momentum_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """SGD momentum ramps ``warmup_momentum`` -> ``momentum`` over the warmup."""
    warmup_steps = int(cfg.warmup_epochs * cfg.steps_per_epoch)
    if warmup_steps <= 0:
        return lambda step: cfg.momentum

    def schedule(step: int) -> float:
        t = min(max(step / warmup_steps, 0.0), 1.0)
        return cfg.warmup_momentum + (cfg.momentum - cfg.warmup_momentum) * t

    return schedule


def param_groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """The three groups: conv kernels (decayed), BatchNorm weights, biases."""
    groups: Dict[str, List[nn.Parameter]] = {"decay": [], "no_decay": [], "bias": []}
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                groups["bias"].append(p)
            elif isinstance(mod, nn.Conv2d):
                groups["decay"].append(p)
            else:
                groups["no_decay"].append(p)
    return groups


class Optimizer:
    """A ``torch.optim`` optimizer over the three groups, and the schedules
    that set its hyperparameters. ``step(update_index)`` sets each group's
    lr (and SGD momentum) for that update, then applies it."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        groups = param_groups(model)
        name = cfg.name.lower()
        if name not in ("sgd", "auto", "adam", "adamw"):
            raise ValueError(f"unknown optimizer: {cfg.name}")
        decay = cfg.weight_decay if name != "adam" else 0.0
        spec = [{"params": groups["decay"], "weight_decay": decay, "schedule": "main"},
                {"params": groups["no_decay"], "weight_decay": 0.0, "schedule": "main"},
                {"params": groups["bias"], "weight_decay": 0.0, "schedule": "bias"}]
        self.lr = {"main": lr_schedule(cfg), "bias": lr_schedule(cfg, cfg.warmup_bias_lr)}
        self.momentum = None
        if name in ("sgd", "auto"):
            self.momentum = momentum_schedule(cfg)
            self.torch = torch.optim.SGD(spec, lr=0.0, momentum=cfg.momentum, nesterov=True)
        else:
            self.torch = torch.optim.Adam(spec, lr=0.0, betas=(cfg.momentum, 0.999), eps=1e-8)

    def step(self, update_index: int) -> None:
        for group in self.torch.param_groups:
            group["lr"] = self.lr[group["schedule"]](update_index)
            if self.momentum is not None:
                group["momentum"] = self.momentum(update_index)
        self.torch.step()

    def zero_grad(self) -> None:
        self.torch.zero_grad(set_to_none=True)


class accumulate_gradients:
    """Gradient accumulation, the counterpart of the JAX package's
    ``accumulate_gradients`` (the ultralytics BaseTrainer cadence,
    ``accumulate = max(round(nbs / batch), 1)``): the gradients of ``k``
    micro-batches SUM in ``.grad`` (the backward adds to it), and every
    ``k``-th ``step()`` applies ``inner`` once and clears them. ``mean``
    divides the sum by ``k`` first, for the batch-mean loss, where a raw SUM
    would multiply the effective lr by k. ``inner``'s schedules count the
    applied updates, so their windows are in optimizer steps."""

    def __init__(self, k: int, inner: Optimizer, mean: bool = False):
        self.k, self.inner, self.mean = max(int(k), 1), inner, mean
        self.micro = 0     # micro-batches summed since the last update
        self.updates = 0   # updates applied

    def zero_grad(self) -> None:
        """Clear the gradients at the start of a window; inside one they sum."""
        if self.micro == 0:
            self.inner.zero_grad()

    def step(self) -> bool:
        """Count one micro-batch; apply the update at the window's end.
        Returns whether it did."""
        self.micro += 1
        if self.micro < self.k:
            return False
        if self.mean and self.k > 1:
            torch._foreach_div_([p.grad for p in self._params() if p.grad is not None],
                                float(self.k))
        self.inner.step(self.updates)
        self.updates += 1
        self.micro = 0
        return True

    def _params(self) -> List[nn.Parameter]:
        return [p for g in self.inner.torch.param_groups for p in g["params"]]

    def state_dict(self) -> Dict:
        """The optimizer's state, the counts and, inside a window, the
        gradients summed so far (on the host)."""
        grads = [None if p.grad is None else p.grad.detach().cpu() for p in self._params()]
        return {"optimizer": self.inner.torch.state_dict(), "micro": self.micro,
                "updates": self.updates, "grads": grads if self.micro else None}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.torch.load_state_dict(state["optimizer"])
        self.micro, self.updates = int(state["micro"]), int(state["updates"])
        for p, g in zip(self._params(), state["grads"] or []):
            p.grad = None if g is None else g.to(p.device)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], step: int,
               decay: float = 0.9999) -> None:
    """In place: ema = ema * d + p * (1 - d), d = decay * (1 - exp(-step/2000)).
    Parameters only: the JAX EMA does not cover the batch statistics."""
    d = decay * (1 - math.exp(-step / 2000.0))
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=1 - d)

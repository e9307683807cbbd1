"""Optimizer: SGD/Adam with warmup + linear/cosine LR, weight decay on conv
kernels only, a bias group that warms down, and parameter EMA.

Counterpart of ``deal_yolo_daya_tpu/train/optimizer.py``. The JAX package
builds one optax chain; here the same arithmetic runs as foreach updates
over three parameter groups:

- ``decay``: conv kernels, the only leaves with weight decay;
- ``no_decay``: BatchNorm weights (flax's ``scale``);
- ``bias``: every leaf named ``bias`` (BatchNorm biases and the head's conv
  biases), on the schedule that warms down from ``warmup_bias_lr``.

The hyperparameters that move from step to step (each group's lr, SGD's
momentum, Adam's bias corrections, the EMA decay) are not Python numbers
but entries of one small device vector, ``hyper``, laid out by the ``H_*``
columns below and filled from the schedules before each step. The update
reads them on the device, so the same code serves the eager step and the
step replayed as a CUDA graph (``train/step_graph.py``), which could not
see a Python float change. The state (momentum buffers, Adam moments, the
gradients) is made up front, so no step allocates it.

optax's ``add_decayed_weights`` in front of nesterov SGD is
``torch.optim.SGD(nesterov=True, weight_decay=...)``: d = g + wd p,
buf = m buf + d, p -= lr (d + m buf). The JAX "adamw" chains
``add_decayed_weights`` before ``adam``: coupled L2, as
``torch.optim.Adam(weight_decay=...)`` and not ``torch.optim.AdamW``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn as nn

# the columns of the hyperparameter vector a step reads on the device
H_LR_MAIN = 0     # the step size of the decay and no_decay groups
H_LR_BIAS = 1     # the step size of the bias group
H_MOMENTUM = 2    # SGD momentum
H_BC2_SQRT = 3    # Adam: sqrt(1 - beta2 ** t)
H_EMA_DECAY = 4   # the EMA decay of this step (1.0 where it does not move)
H_GRAD_KEEP = 5   # 0.0 at the first micro-batch of an update: clears .grad
N_HYPER = 6
EMA_DECAY = 0.9999
ADAM_BETA2, ADAM_EPS = 0.999, 1e-8


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


def ema_decay(step: int, decay: float = EMA_DECAY) -> float:
    """The EMA decay after ``step`` updates: decay * (1 - exp(-step/2000))."""
    return decay * (1 - math.exp(-step / 2000.0))


def named_param_groups(model: nn.Module) -> Dict[str, List[str]]:
    """The three groups by parameter name: conv kernels (decayed), BatchNorm
    weights, biases. Parameters that take no gradient (frozen modules) are
    left out."""
    groups: Dict[str, List[str]] = {"decay": [], "no_decay": [], "bias": []}
    for prefix, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            full = f"{prefix}.{name}" if prefix else name
            if name == "bias":
                groups["bias"].append(full)
            elif isinstance(mod, nn.Conv2d):
                groups["decay"].append(full)
            else:
                groups["no_decay"].append(full)
    return groups


def param_groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """``named_param_groups``' parameters."""
    return {k: [model.get_parameter(n) for n in names]
            for k, names in named_param_groups(model).items()}


class _Group:
    def __init__(self, params: List[nn.Parameter], weight_decay: float, column: int, adam: bool):
        self.params, self.weight_decay, self.column = params, weight_decay, column
        with torch.no_grad():
            for p in params:  # gradients made up front: the backward adds into them
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        self.state = {"exp_avg": zeros(), "exp_avg_sq": zeros()} if adam \
            else {"momentum_buffer": zeros()}

    @property
    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params]


class Optimizer:
    """Nesterov SGD (``sgd``, ``auto``) or Adam (``adam``; ``adamw`` with
    the coupled L2) over the three groups. ``hyper_row(update_index)`` gives
    the host values of the ``H_LR_*``, ``H_MOMENTUM`` and ``H_BC2_SQRT``
    columns for that update; ``step(hyper)`` applies one update reading them
    from the device vector ``hyper``. No host read, no allocation that
    outlives the call."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        groups = param_groups(model)
        name = cfg.name.lower()
        if name not in ("sgd", "auto", "adam", "adamw"):
            raise ValueError(f"unknown optimizer: {cfg.name}")
        self.adam = name in ("adam", "adamw")
        self.beta1 = cfg.momentum
        decay = cfg.weight_decay if name != "adam" else 0.0
        self.groups = [_Group(groups["decay"], decay, H_LR_MAIN, self.adam),
                       _Group(groups["no_decay"], 0.0, H_LR_MAIN, self.adam),
                       _Group(groups["bias"], 0.0, H_LR_BIAS, self.adam)]
        self.lr = {H_LR_MAIN: lr_schedule(cfg), H_LR_BIAS: lr_schedule(cfg, cfg.warmup_bias_lr)}
        self.momentum = momentum_schedule(cfg)

    def grads(self) -> List[torch.Tensor]:
        return [t for g in self.groups for t in g.grads]

    @torch.no_grad()
    def flatten_grads(self, last: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """Move every gradient into one flat buffer and return it: each
        ``.grad`` becomes a view of it with its parameter's strides, so that
        the backward adds into the buffer and one all-reduce of it carries
        every gradient (data parallelism). The parameters in ``last`` (by
        identity; tensor parallelism's sharded ones) take its end, the rest
        its start, in group order. Idempotent."""
        at_end = {id(p) for p in last}
        params = [p for g in self.groups for p in g.params]
        params = [p for p in params if id(p) not in at_end] + \
            [p for p in params if id(p) in at_end]
        flat = getattr(self, "flat_grad", None)
        if flat is not None or not params:
            return flat
        if len({p.dtype for p in params}) != 1:
            raise TypeError("the flat gradient buffer holds parameters of one dtype")
        flat = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype,
                           device=params[0].device)
        offset = 0
        for p in params:
            view = torch.as_strided(flat, p.shape, p.stride(), offset)
            view.copy_(p.grad)
            p.grad = view
            offset += p.numel()
        self.flat_grad = flat
        return flat

    def hyper_row(self, update_index: int) -> Dict[int, float]:
        """The optimizer's columns of ``hyper`` for update ``update_index``
        (0-based): Adam's step size folds in 1 / (1 - beta1 ** t)."""
        row = {col: fn(update_index) for col, fn in self.lr.items()}
        if self.adam:
            t = update_index + 1
            for col in self.lr:
                row[col] /= 1 - self.beta1 ** t
            row[H_BC2_SQRT] = math.sqrt(1 - ADAM_BETA2 ** t)
        else:
            row[H_MOMENTUM] = self.momentum(update_index)
        return row

    @torch.no_grad()
    def step(self, hyper: torch.Tensor) -> None:
        for g in self.groups:
            if not g.params:
                continue
            grads = g.grads
            d = (torch._foreach_add(grads, g.params, alpha=g.weight_decay) if g.weight_decay
                 else grads)
            lr = hyper[g.column]
            if self.adam:
                m, v = g.state["exp_avg"], g.state["exp_avg_sq"]
                torch._foreach_lerp_(m, d, 1 - self.beta1)
                torch._foreach_mul_(v, ADAM_BETA2)
                torch._foreach_addcmul_(v, d, d, value=1 - ADAM_BETA2)
                denom = torch._foreach_sqrt(v)
                torch._foreach_div_(denom, hyper[H_BC2_SQRT])
                torch._foreach_add_(denom, ADAM_EPS)
                upd = torch._foreach_div(m, denom)
            else:
                mom, buf = hyper[H_MOMENTUM], g.state["momentum_buffer"]
                torch._foreach_mul_(buf, mom)
                torch._foreach_add_(buf, d)
                upd = torch._foreach_mul(buf, mom)
                torch._foreach_add_(upd, d)
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(g.params, upd)

    def state_dict(self) -> Dict:
        """{"state": {index: {name: tensor}}}, one index a parameter in
        group order (``torch.optim``'s layout); the tensors are the live
        buffers (copy them to keep them)."""
        state, i = {}, 0
        for g in self.groups:
            for j in range(len(g.params)):
                state[i] = {k: v[j] for k, v in g.state.items()}
                i += 1
        return {"state": state}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Copy a ``state_dict()`` into the existing buffers, in place."""
        i = 0
        for g in self.groups:
            for j in range(len(g.params)):
                for k, v in g.state.items():
                    v[j].copy_(sd["state"][i][k])
                i += 1


class accumulate_gradients:
    """Gradient accumulation, the counterpart of the JAX package's
    ``accumulate_gradients`` (the ultralytics BaseTrainer cadence,
    ``accumulate = max(round(nbs / batch), 1)``): the gradients of ``k``
    micro-batches SUM in ``.grad`` (the backward adds to it), and the
    ``k``-th applies ``inner`` once. ``mean`` divides the sum by ``k`` first,
    for the batch-mean loss, where a raw SUM would multiply the effective lr
    by k. ``inner``'s schedules count the applied updates, so their windows
    are in optimizer steps.

    The counts stay on the host: ``window()`` says what the next micro-batch
    is (its ``H_GRAD_KEEP`` and whether it ends with the update) and
    ``advance()`` counts it."""

    def __init__(self, k: int, inner: Optimizer, mean: bool = False):
        self.k, self.inner, self.mean = max(int(k), 1), inner, mean
        self.micro = 0     # micro-batches summed since the last update
        self.updates = 0   # updates applied

    def window(self):
        """(grad_keep, updates) for the next micro-batch: grad_keep 0.0 at
        the first of a window (the backward then starts from zeros),
        ``updates`` whether it applies the update."""
        return (0.0 if self.micro == 0 else 1.0), self.micro + 1 >= self.k

    def advance(self) -> bool:
        """Count one micro-batch; returns whether it applied the update."""
        self.micro += 1
        if self.micro < self.k:
            return False
        self.updates += 1
        self.micro = 0
        return True

    @torch.no_grad()
    def apply(self, hyper: torch.Tensor) -> None:
        """The update at a window's end, on the summed gradients."""
        if self.mean and self.k > 1:
            torch._foreach_div_(self.inner.grads(), float(self.k))
        self.inner.step(hyper)

    def state_dict(self) -> Dict:
        """The optimizer's state, the counts and, inside a window, the
        gradients summed so far (live tensors, as ``Optimizer.state_dict``)."""
        grads = [g.detach() for g in self.inner.grads()]
        return {"optimizer": self.inner.state_dict(), "micro": self.micro,
                "updates": self.updates, "grads": grads if self.micro else None}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["optimizer"])
        self.micro, self.updates = int(state["micro"]), int(state["updates"])
        for g, saved in zip(self.inner.grads(), state["grads"] or []):
            g.copy_(saved)


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], decay) -> None:
    """In place: ema = ema * d + p * (1 - d). ``decay`` is the step count
    (d = ``ema_decay(step)``) or d itself as a 0-d device tensor. Parameters
    only: the JAX EMA does not cover the batch statistics."""
    if not isinstance(decay, torch.Tensor):
        decay = torch.tensor(ema_decay(decay), dtype=torch.float32, device=ema[0].device)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1 - decay))

"""Write an ultralytics-layout detection checkpoint (.pt) from a state dict,
without ultralytics installed.

    write_checkpoint(path, state_dict, names={0: "a", ...})

The file has the layout of an ultralytics ``best.pt``: a dict with
``epoch``, ``best_fitness``, ``model`` (None), ``ema`` (the detection model
as a pickled module tree), ``updates``, ``optimizer`` (None),
``train_args`` and ``date``. The module tree's classes are stand-ins,
registered under ``ultralytics.nn.tasks`` only while pickling, so a reader
finds them nowhere (as a machine without ultralytics finds the real ones):
``DetectionModel`` (with ``names`` and ``stride``) holding ``model``, a tree
of ``Block`` modules whose parameters and buffers carry the state dict's
keys ("model.0.conv.weight", ...). Values are stored in ``dtype`` (fp16, as
ultralytics saves). ``wrap_ema`` puts the model inside a ``ModelEMA``
object (``.ema``), as a checkpoint of an EMA wrapper holds it. The tests
(tests/test_torch_port_torch_import.py) and ``chip_smoke.py`` load this file
by path.
"""

from __future__ import annotations

import contextlib
import sys
import types
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

TASKS = "ultralytics.nn.tasks"


class Block(nn.Module):
    """Stand-in for an ultralytics module (Conv, C3k2, Detect, ...)."""


class DetectionModel(nn.Module):
    """Stand-in for ``ultralytics.nn.tasks.DetectionModel``."""


class ModelEMA:
    """Stand-in for ``ultralytics.utils.torch_utils.ModelEMA``: the model on ``ema``."""

    def __init__(self, ema: nn.Module, updates: int = 0):
        self.ema, self.updates = ema, updates


@contextlib.contextmanager
def _registered():
    """The stand-in classes importable as ``ultralytics.nn.tasks.*`` while
    pickling, and nowhere afterwards."""
    names = ("ultralytics", "ultralytics.nn", TASKS)
    saved = {n: sys.modules.get(n) for n in names}
    tasks = types.ModuleType(TASKS)
    for cls in (Block, DetectionModel, ModelEMA):
        cls.__module__, cls.__qualname__ = TASKS, cls.__name__
        setattr(tasks, cls.__name__, cls)
    sys.modules.update({"ultralytics": types.ModuleType("ultralytics"),
                        "ultralytics.nn": types.ModuleType("ultralytics.nn"), TASKS: tasks})
    try:
        yield
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
        for cls in (Block, DetectionModel, ModelEMA):
            cls.__module__, cls.__qualname__ = __name__, cls.__name__


def module_tree(state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype,
                names: Dict[int, str]) -> DetectionModel:
    """A ``DetectionModel`` whose ``model`` holds every key of ``state_dict``
    (keys without the "model." prefix) as a parameter, or as a buffer for BN
    statistics."""
    root = DetectionModel()
    root.add_module("model", Block())
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = root.model
        for seg in path:
            if seg not in node._modules:
                node.add_module(seg, Block())
            node = node._modules[seg]
        value = torch.as_tensor(value).detach().to(dtype).clone()
        if leaf.startswith("running_") or leaf == "num_batches_tracked":
            node.register_buffer(leaf, value)
        else:
            node.register_parameter(leaf, nn.Parameter(value, requires_grad=False))
    root.names = dict(names)
    root.stride = torch.tensor([8.0, 16.0, 32.0])
    return root


def write_checkpoint(path, state_dict: Mapping[str, torch.Tensor],
                     names: Optional[Dict[int, str]] = None, dtype: torch.dtype = torch.float16,
                     wrap_ema: bool = False) -> Path:
    """Write ``state_dict`` (ultralytics keys, no "model." prefix) as an
    ultralytics-layout best.pt at ``path``."""
    names = names if names is not None else {}
    model = module_tree(state_dict, dtype, names)
    ckpt = {"epoch": -1, "best_fitness": None, "model": None,
            "ema": ModelEMA(model, 100) if wrap_ema else model, "updates": 100,
            "optimizer": None, "train_args": {"imgsz": 640, "task": "detect"},
            "date": "2026-01-01T00:00:00"}
    with _registered():
        torch.save(ckpt, str(path))
    return Path(path)

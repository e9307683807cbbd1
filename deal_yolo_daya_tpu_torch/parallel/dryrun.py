"""Parallel steps on tiny shapes: ``dryrun_multichip(n)``, the counterpart
of ``__graft_entry__.dryrun_multichip``, and ``dp_steps``, the per-rank body
it runs (also the tests' and chip_smoke's).

``dryrun_multichip(n)`` runs one full train step (forward, backward, SGD,
EMA) of yolo11n at 64 px over n ranks: NCCL over n cards where there are n,
else gloo over n CPU ranks (the JAX dry run's virtual CPU mesh); within
``init_distributed``'s cluster, over its devices. As in the JAX dry run, an
even n >= 4 splits off a 2-way model axis (an n/2 x 2 mesh, the convs of
128 channels and more sharded), else the mesh is n x 1; the batch is 2 x
the data axis. It checks that every rank ends with the same whole
parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import launch
from .mesh import Device, create_mesh, visible_devices

LOSS_PARTS = ("box_loss", "cls_loss", "dfl_loss", "num_fg")
DRYRUN_MIN_CHANNELS = 128  # the JAX dry run's tp_param_shardings threshold


def dp_steps(dp, cfg, nc: int, state_dict: Optional[Dict[str, torch.Tensor]],
             batch: Sequence[np.ndarray], seeds: Sequence[int], aug=None,
             device=None, steps_per_epoch: int = 100, dtype=None,
             min_channels: int = 256) -> Dict[str, Any]:
    """``len(seeds)`` train steps of a ``TrainState`` from ``state_dict`` on
    the global ``batch`` (numpy): with ``dp`` (a rank) on this rank's rows,
    else (one process) on all of it; under a model axis the convs of
    ``min_channels`` and more are sharded. With ``aug`` (a
    ``DeviceAugConfig``) ``batch`` is raw (images, hw, boxes, classes, mask)
    and each step augments it on the card with its seed (the global draws);
    else it is (images, boxes, classes, mask). -> numpy: ``loss`` the loss
    parts summed over the steps and the data ranks, ``grads`` the first
    step's gradients (summed over the ranks), ``state`` the model's state
    dict and ``ema`` the EMA after the last step, all whole; ``sharded`` the
    names of the sharded weights and ``replicated`` this rank's replicated
    parameters after the last step. ``dtype`` (without amp): the
    parameters' dtype, float64 for comparisons below f32's rounding."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype or saved)
    try:
        return _dp_steps(dp, cfg, nc, state_dict, batch, seeds, aug, device, steps_per_epoch,
                         min_channels)
    finally:
        torch.set_default_dtype(saved)


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _dp_steps(dp, cfg, nc, state_dict, batch, seeds, aug, device, steps_per_epoch,
              min_channels):
    from ..train.device_augment import augment_batch
    from ..train.trainer import TrainState

    device = dp.device if dp is not None else torch.device(device or "cpu")
    state = TrainState(cfg, nc, steps_per_epoch, device=device, state_dict=state_dict)
    if dp is not None:
        state.attach(dp, min_channels)
    rows = dp.rows(len(batch[0])) if dp is not None else slice(None)
    local = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(device) for a in batch]
    record: Dict[str, Any] = {"sharded": sorted(state.tp)}
    for i, seed in enumerate(seeds):
        step_batch = local if aug is None else augment_batch(
            *local, seed, cfg.imgsz, aug, max_boxes=cfg.max_boxes, dp=dp)
        state.step(*step_batch)
        if i == 0:
            record["grads"] = _numpy(state.whole(
                {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}))
    acc = torch.stack([state.loss_acc[k] for k in LOSS_PARTS])
    if dp is not None:
        dp.all_reduce_(acc)
    record["loss"] = dict(zip(LOSS_PARTS, acc.cpu().tolist()))
    record["replicated"] = _numpy({n: p for n, p in state.model.named_parameters()
                                   if n not in state.tp})
    views = state.state_views()
    record["state"], record["ema"] = _numpy(views["model"]), _numpy(views["ema"])
    state.detach()
    return record


def _dryrun_rank(dp, n_data: int, seed: int) -> Dict[str, Any]:
    from ..train.trainer import TrainConfig

    imgsz, nc, batch = 64, 4, 2 * n_data
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, imgsz / 2, (batch, 4, 2)).astype(np.float32)
    data = (rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8),
            np.concatenate([xy, xy + imgsz / 4], -1),
            rng.integers(0, nc, (batch, 4)).astype(np.int32), rng.random((batch, 4)) > 0.3)
    cfg = TrainConfig(model="yolo11n", imgsz=imgsz, batch=batch, epochs=1, amp=False, seed=seed,
                      max_boxes=4)
    rec = dp_steps(dp, cfg, nc, None, data, [seed], min_channels=DRYRUN_MIN_CHANNELS)
    params = sum(float(np.float64(v).sum()) for v in rec["state"].values())
    every = torch.zeros(dp.global_world, dtype=torch.float64, device=dp.device)
    every[dp.global_rank] = params
    dp.everyone.all_reduce_(every)  # every rank's sum, over the whole world
    return {"rank": dp.global_rank, "loss": rec["loss"], "param_sums": every.cpu().tolist(),
            "sharded": rec["sharded"], "device": str(dp.device), "backend": dp.backend}


def dryrun_multichip(n_devices: int, seed: int = 0) -> Dict[str, Any]:
    """One train step over ``n_devices`` ranks (see the module docstring)
    -> {"ranks": each rank's record, "loss": the global loss parts, "mesh":
    (data, model)}; raises if the ranks disagree on the parameters."""
    devices = visible_devices()
    if len(devices) < n_devices:  # the JAX dry run's virtual CPU mesh
        devices = [Device("cpu", i, 0, i, "cpu") for i in range(n_devices)]
    n_data, n_model = (n_devices // 2, 2) if n_devices >= 4 and n_devices % 2 == 0 \
        else (n_devices, 1)
    mesh = create_mesh(n_data, n_model, devices=devices[:n_devices])
    args = (n_data, seed)
    ranks = launch.start(mesh, _dryrun_rank, args, timeout_s=600.0)
    try:
        mine = _dryrun_rank(ranks.dp, *args)
    except BaseException:
        ranks.close(failed=True)
        raise
    records = [mine] + ranks.close()
    sums = set(mine["param_sums"])
    if len(sums) != 1:
        raise RuntimeError(f"the ranks disagree on the whole parameters after a step: {sums}")
    loss = mine["loss"]
    if not all(np.isfinite(v) for v in loss.values()):
        raise RuntimeError(f"a non-finite loss: {loss}")
    return {"ranks": records, "loss": loss, "mesh": (n_data, n_model)}

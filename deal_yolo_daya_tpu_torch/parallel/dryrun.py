"""Data-parallel steps on tiny shapes: ``dryrun_multichip(n)``, the
counterpart of ``__graft_entry__.dryrun_multichip``, and ``dp_steps``, the
per-rank body it runs (also the tests' and chip_smoke's).

``dryrun_multichip(n)`` runs one full data-parallel train step (forward,
backward, SGD, EMA) of yolo11n at 64 px, batch 2n, over n ranks: NCCL over n
cards where there are n, else gloo over n CPU ranks (the JAX dry run's
virtual CPU mesh); within ``init_distributed``'s cluster, over its devices.
It checks that every rank ends with the same parameters. Data parallelism
only: the JAX dry run's 2-way model axis for n >= 4 waits for tensor
parallelism (ROADMAP.md section 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import launch
from .mesh import Device, create_mesh, visible_devices

LOSS_PARTS = ("box_loss", "cls_loss", "dfl_loss", "num_fg")


def dp_steps(dp, cfg, nc: int, state_dict: Optional[Dict[str, torch.Tensor]],
             batch: Sequence[np.ndarray], seeds: Sequence[int], aug=None,
             device=None, steps_per_epoch: int = 100, dtype=None) -> Dict[str, Any]:
    """``len(seeds)`` train steps of a ``TrainState`` from ``state_dict`` on
    the global ``batch`` (numpy): with ``dp`` (a rank) on this rank's rows,
    else (one process) on all of it. With ``aug`` (a ``DeviceAugConfig``)
    ``batch`` is raw (images, hw, boxes, classes, mask) and each step
    augments it on the card with its seed (the global draws); else it is
    (images, boxes, classes, mask). -> numpy: ``loss`` the loss parts
    summed over the steps and the ranks, ``grads`` the first step's
    gradients (summed over the ranks), ``state`` the model's state dict and
    ``ema`` the EMA after the last step. ``dtype`` (without amp): the
    parameters' dtype, float64 for comparisons below f32's rounding."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype or saved)
    try:
        return _dp_steps(dp, cfg, nc, state_dict, batch, seeds, aug, device, steps_per_epoch)
    finally:
        torch.set_default_dtype(saved)


def _dp_steps(dp, cfg, nc, state_dict, batch, seeds, aug, device, steps_per_epoch):
    from ..train.device_augment import augment_batch
    from ..train.trainer import TrainState

    device = dp.device if dp is not None else torch.device(device or "cpu")
    state = TrainState(cfg, nc, steps_per_epoch, device=device, state_dict=state_dict)
    if dp is not None:
        state.attach(dp)
    rows = dp.rows(len(batch[0])) if dp is not None else slice(None)
    local = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(device) for a in batch]
    record: Dict[str, Any] = {}
    for i, seed in enumerate(seeds):
        step_batch = local if aug is None else augment_batch(
            *local, seed, cfg.imgsz, aug, max_boxes=cfg.max_boxes, dp=dp)
        state.step(*step_batch)
        if i == 0:
            record["grads"] = {n: p.grad.detach().cpu().numpy().copy()
                               for n, p in state.model.named_parameters() if p.grad is not None}
    acc = torch.stack([state.loss_acc[k] for k in LOSS_PARTS])
    if dp is not None:
        dp.all_reduce_(acc)
    record["loss"] = dict(zip(LOSS_PARTS, acc.cpu().tolist()))
    record["state"] = {k: v.detach().cpu().numpy().copy()
                       for k, v in state.model.state_dict().items()}
    record["ema"] = {k: v.detach().cpu().numpy().copy()
                     for k, v in state.ema_state_dict().items()}
    state.detach()
    return record


def _dryrun_rank(dp, n_devices: int, seed: int) -> Dict[str, Any]:
    from ..train.trainer import TrainConfig

    imgsz, nc, batch = 64, 4, 2 * n_devices
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, imgsz / 2, (batch, 4, 2)).astype(np.float32)
    data = (rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8),
            np.concatenate([xy, xy + imgsz / 4], -1),
            rng.integers(0, nc, (batch, 4)).astype(np.int32), rng.random((batch, 4)) > 0.3)
    cfg = TrainConfig(model="yolo11n", imgsz=imgsz, batch=batch, epochs=1, amp=False, seed=seed,
                      max_boxes=4)
    rec = dp_steps(dp, cfg, nc, None, data, [seed])
    params = sum(float(np.float64(v).sum()) for v in rec["state"].values())
    every = dp.all_gather(torch.tensor([params], dtype=torch.float64, device=dp.device))
    return {"rank": dp.rank, "loss": rec["loss"], "param_sums": every.cpu().tolist(),
            "device": str(dp.device), "backend": dp.backend}


def dryrun_multichip(n_devices: int, seed: int = 0) -> Dict[str, Any]:
    """One data-parallel train step over ``n_devices`` ranks (see the module
    docstring) -> {"ranks": each rank's record, "loss": the global loss
    parts}; raises if the ranks disagree on the parameters."""
    devices = visible_devices()
    if len(devices) < n_devices:  # the JAX dry run's virtual CPU mesh
        devices = [Device("cpu", i, 0, i, "cpu") for i in range(n_devices)]
    mesh = create_mesh(n_devices, devices=devices)
    args = (n_devices, seed)
    ranks = launch.start(mesh, _dryrun_rank, args, timeout_s=600.0)
    try:
        mine = _dryrun_rank(ranks.dp, *args)
    except BaseException:
        ranks.close(failed=True)
        raise
    records = [mine] + ranks.close()
    sums = set(mine["param_sums"])
    if len(sums) != 1:
        raise RuntimeError(f"the ranks disagree on the parameters after a step: {sums}")
    loss = mine["loss"]
    if not all(np.isfinite(v) for v in loss.values()):
        raise RuntimeError(f"a non-finite loss: {loss}")
    return {"ranks": records, "loss": loss}

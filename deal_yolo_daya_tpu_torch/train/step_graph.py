"""The train step as a CUDA graph: the counterpart of the JAX Trainer's
chunked dispatch (``train_chunk``, a ``lax.scan`` of K gather -> augment ->
train iterations in one device program, ``deal_yolo_daya_tpu/train/
trainer.py:700-723``).

``StepProgram`` holds static device buffers for one step of the
device-cache path: the (B,) batch indices and the augmentation draws.
``stage(idx, seed)`` fills them, and the hyperparameter vector
(``TrainState.next_hyper``), on the current stream; ``iteration()``
gathers the batch from the device cache by the indices, augments it
(``device_augment.apply``) and runs ``TrainState.iteration``: forward,
loss, backward, optimizer, EMA and the loss sums. ``run(idx, seeds)`` runs
a dispatch of K steps, stage then iteration each, with no host read.

On the card each iteration is a replay of one CUDA graph. The first
``WARMUP_RUNS`` iterations of a graph run eagerly on a side stream (the
kernel builds, cuDNN's choice and the kernels' once-a-process attributes
happen there) and are the run's real steps, counted and seeded as such;
then the iteration is captured once with ``capture_error_mode=
"thread_local"`` into a memory pool the program's graphs share. A capture
that fails raises. Each replay adds the graph's kernel launches to the
kernels' counters. With gradient accumulation there are two graphs: the
micro-batch alone, and the micro-batch with the update; the host's counts
pick one. On the CPU ``iteration()`` runs eagerly: the callable the tests
hold against the JAX package's chunked dispatch.

The random draws stay outside the graph: each step's ``torch.Generator``
is seeded anew (``step_seed``), which a replayed generator would not do.

Six phase stamps (``ops/kernels/phase_stamp.py``) are part of every
iteration, and so of every graph: at its entry, after ``apply``, in
``TrainState.loss`` between the forward and the loss, after the loss,
after the backward and at its end. They split the step's device time into
augment, forward, loss, backward and optimizer (``phase_ms()``). The host
spans ``train.dispatch`` (a ``run``), ``train.stage``, ``train.replay``,
``train.warmup`` (an eager warm-up step) and ``train.capture`` time the
host's side (``tracing``).

Under data parallelism (``state.dp``) the cache is this rank's shard and the
indices are local to it; the iteration gathers the ranks' rows into the
global raw batch, augments this rank's rows with the global draws and runs
the distributed iteration, so the graph holds every collective of the step
(the raw-batch all_gather, the BatchNorm moments, the loss normaliser, the
gradient all-reduce); under a model axis also the model group's (each
sharded conv's channel all_gather and input-gradient SUM, the replicated
gradients' broadcast). NCCL's collectives can be captured; gloo's cannot,
and a program over a gloo group on the card raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..ops.kernels._build import GraphLaunches
from ..ops.kernels.phase_stamp import Ring, skip
from .device_augment import DeviceAugConfig, apply, draw

WARMUP_RUNS = 3


def auto_steps_per_dispatch(k: Optional[int], n_batches: int,
                            single_device: bool = True) -> int:
    """``steps_per_dispatch`` resolved as the JAX Trainer resolves it: the
    given value (at least 1), or for None 1 on several devices (per-step
    dispatch) and on one the largest K in [4, 16] that divides the epoch's
    batch count, else 8."""
    if k is not None:
        return max(1, int(k))
    if not single_device:
        return 1
    for cand in range(16, 3, -1):
        if n_batches and n_batches % cand == 0:
            return cand
    return 8


class StepProgram:
    """Train steps of the device-cache path; see the module docstring.
    ``cache`` is the Trainer's device cache (images, hw, boxes, classes,
    mask of the whole train set); ``aug_cfg`` the augmentation of the
    epochs it serves (``close_mosaic`` makes another program)."""

    def __init__(self, state, cache: Sequence[torch.Tensor], aug_cfg: DeviceAugConfig,
                 imgsz: int, max_boxes: int, batch: int):
        dev = state.device
        dp = state.dp
        if dp is not None and dev.type == "cuda" and not dp.capturable:
            raise RuntimeError(f"steps_per_dispatch > 1 captures the step's collectives into a "
                               f"CUDA graph, which the {dp.backend} backend cannot; use NCCL or "
                               "steps_per_dispatch=1")
        self.state, self.cache, self.aug_cfg = state, tuple(cache), aug_cfg
        self.imgsz, self.max_boxes, self.batch = imgsz, max_boxes, batch
        self.rows = dp.rows(batch) if dp is not None else None
        local = batch // dp.world if dp is not None else batch
        self.idx = torch.zeros((local,), dtype=torch.long, device=dev)
        self.draws = draw(batch, torch.Generator(device=dev).manual_seed(0), aug_cfg, dev)
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.launches: Dict[bool, GraphLaunches] = {}
        self.totals: Dict[bool, torch.Tensor] = {}
        self.eager_runs: Dict[bool, int] = {}
        self.pool = None
        self.capture_s = 0.0
        self.stamps = Ring(dev)

    def iteration(self, update: bool) -> torch.Tensor:
        """One step from the static buffers, stamped: what the graph captures."""
        self.stamps(0)
        batch = tuple(t.index_select(0, self.idx) for t in self.cache)
        if self.state.dp is not None:
            batch = self.state.dp.gather_rows(batch)
        aug = apply(*batch, self.draws, self.imgsz, self.aug_cfg, self.max_boxes, self.rows)
        self.stamps(1)
        self.state.stamp = self.stamps  # TrainState's stamps 2-5, for this step
        try:
            return self.state.iteration(*aug, update)
        finally:
            self.state.stamp = skip

    def phase_ms(self) -> Optional[Dict[str, float]]:
        """Each phase's median device milliseconds over the last replayed
        (or eager) steps the stamps' ring holds; None on the CPU."""
        return self.stamps.phase_ms()

    def stage(self, idx: np.ndarray, seed: int) -> bool:
        """Copy one step's indices (this rank's B / D under data
        parallelism), the global batch's draws and its hyperparameter row
        into the buffers, and count the step -> its ``update``."""
        dev = self.state.device
        pin = dev.type == "cuda"
        rows = torch.from_numpy(np.asarray(idx, np.int64))
        self.idx.copy_(rows.pin_memory() if pin else rows, non_blocking=pin)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for buf, t in zip(self.draws, draw(self.batch, gen, self.aug_cfg, dev)):
            buf.copy_(t)
        return self.state.next_hyper()

    def run(self, idx: np.ndarray, seeds: Sequence[int]) -> torch.Tensor:
        """A dispatch: ``idx`` (K, B) dataset indices, ``seeds`` their K
        augmentation seeds -> the last step's total loss (a device tensor)."""
        if len(seeds) != len(idx) or not len(seeds):
            raise ValueError(f"{len(idx)} index rows for {len(seeds)} seeds")
        total = None
        with tracing.span("train.dispatch"):
            for row, seed in zip(idx, seeds):
                with tracing.span("train.stage"):
                    update = self.stage(row, seed)
                total = self._step(update)
        return total

    def _step(self, update: bool) -> torch.Tensor:
        if self.state.device.type != "cuda":
            return self.iteration(update)
        graph = self.graphs.get(update)
        if graph is None and self.eager_runs.get(update, 0) < WARMUP_RUNS:
            self.eager_runs[update] = self.eager_runs.get(update, 0) + 1
            with tracing.span("train.warmup"):
                main = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    total = self.iteration(update)
                main.wait_stream(side)
            return total
        if graph is None:
            graph = self._capture(update)
        with tracing.span("train.replay"):
            graph.replay()
            self.launches[update].replayed()
        return self.totals[update]

    def _capture(self, update: bool) -> torch.cuda.CUDAGraph:
        with tracing.span("train.capture") as sp:
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            launches = self.launches[update] = GraphLaunches()
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"), \
                    launches.capture():
                self.totals[update] = self.iteration(update)
            self.pool = graph.pool()
            self.graphs[update] = graph
        self.capture_s += sp.seconds
        return graph

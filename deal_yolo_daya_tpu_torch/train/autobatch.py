"""Automatic batch size (``batch=-1``): the counterpart of
``deal_yolo_daya_tpu/train/autobatch.py``.

The JAX package compiles the train step at two probe batches and reads
XLA's memory analysis; here the probe runs the path the Trainer will take,
on a throwaway ``TrainState`` and a device cache of the probe's own batch,
at batches 4 and 8: the step program's warm-up steps, its capture and a
replay (or one eager step, off the graphed path), then two validation
batches while the graph's memory pool is held. A probe's bytes are the
larger of the steps' peak (``torch.cuda.max_memory_allocated``) and the
memory reserved under validation (what the pool and the state keep, plus
validation's peak above it). The limit is ``TrainConfig.auto_batch_bytes``
when set, else what this process could hold: the card's free memory plus
what the process has reserved (``torch.cuda.mem_get_info``), less the
bytes the Trainer keeps on the card besides (the train set and the val
batches, with ``cache="device"``). ``fit_and_pick`` (a copy of the JAX
package's) fits the line through the two points and takes the largest
batch under 80% of the limit, capped at 1024.

The CPU reports no device memory: there the choice is the JAX package's
for a backend without a memory analysis, batch 16, with its message.

On D cards (data parallelism) the Trainer probes rank 0's card alone, one
device's path, and takes D times its pick, the same on every rank (the JAX
Trainer's ``n_data * suggest_batch(...)``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

PROBE = (4, 8)      # the probe batches
FRACTION = 0.8      # of the limit the picked batch may use
CAP = 1024          # the largest batch picked


def fit_and_pick(mem_probe: Tuple[int, int], bytes_probe: Tuple[float, float],
                 limit_bytes: float, fraction: float = 0.8, cap: int = 1024,
                 multiple: int = 8) -> int:
    """Pure selection math: linear fit through two (batch, bytes) points,
    largest batch with predicted usage <= fraction*limit, floored to a
    multiple (>= multiple) or to the largest fitting small batch."""
    (b1, b2), (m1, m2) = mem_probe, bytes_probe
    if b2 <= b1:
        raise ValueError(f"probe batches must increase: {mem_probe}")
    slope = (m2 - m1) / (b2 - b1)  # bytes per image
    # a fit flatter than a fifth of the larger probe's per-image average
    # (the probes disagree about the fixed cost) falls back to that average,
    # with no fixed cost: strictly conservative
    avg = m2 / b2
    if slope < 0.2 * avg:
        slope, fixed = avg, 0.0
    else:
        fixed = max(m1 - slope * b1, 0.0)
    budget = fraction * limit_bytes - fixed
    if budget <= 0:
        return 0
    raw = int(budget / slope)
    if raw >= multiple:
        return min(raw // multiple * multiple, cap)
    return max(min(raw, cap), 0)


def probe_path_bytes(make_state: Callable[[], object], imgsz: int, batch: int,
                     max_boxes: int, graphed: bool, evaluate: Optional[Callable]) -> float:
    """The device bytes the Trainer's path needs at ``batch`` (see the
    module docstring). ``evaluate(state, images, boxes, classes, mask,
    inv)`` is one validation batch; validation keeps a batch's outputs
    while the next one runs, so it runs twice here."""
    from .device_augment import DeviceAugConfig
    from .step_graph import WARMUP_RUNS, StepProgram

    state = make_state()
    dev = state.device
    rng = np.random.default_rng(batch)
    xy = rng.uniform(0, imgsz / 2, (batch, max_boxes, 2)).astype(np.float32)
    cache = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8),
        np.full((batch, 2), imgsz, np.float32), np.concatenate([xy, xy + imgsz / 4], -1),
        np.zeros((batch, max_boxes), np.int32), np.ones((batch, max_boxes), bool)))
    images, _, boxes, classes, mask = cache
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prog = None
    if graphed:
        prog = StepProgram(state, cache, DeviceAugConfig(), imgsz, max_boxes, batch)
        n = WARMUP_RUNS + 1
        prog.run(np.tile(np.arange(batch), (n, 1)), list(range(n)))
    else:
        state.step(images, boxes, classes, mask)
    torch.cuda.synchronize(dev)
    steps = float(torch.cuda.max_memory_allocated(dev))
    torch.cuda.empty_cache()
    held = float(torch.cuda.memory_reserved(dev))
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    inv = torch.tensor([1.0, 0.0, 0.0, imgsz, imgsz], device=dev).expand(batch, 5)
    outs = [evaluate(state, images, boxes, classes, mask, inv)
            for _ in range(2 if evaluate else 0)]
    torch.cuda.synchronize(dev)
    val = held + float(torch.cuda.max_memory_allocated(dev) - base)
    del outs, prog, state, cache, images, boxes, classes, mask, inv
    torch.cuda.empty_cache()
    return max(steps, val)


def suggest_batch(make_state: Callable[[], object], imgsz: int, device: torch.device, *,
                  max_boxes: int = 32, limit_bytes: Optional[float] = None,
                  graphed: bool = False, evaluate: Optional[Callable] = None,
                  reserve_bytes: float = 0.0, log: Callable[[str], None] = print) -> int:
    """Resolve batch=-1 -> the batch (>= 1), with the JAX package's log line.
    ``limit_bytes`` (``TrainConfig.auto_batch_bytes``) replaces the card's;
    ``reserve_bytes`` of it are kept for what the Trainer holds besides the
    path; ``graphed`` probes the step program; ``evaluate`` is one
    validation batch (see ``probe_path_bytes``)."""
    probe, fraction = PROBE, FRACTION
    if device.type != "cuda":
        log("[autobatch] memory probe unavailable (the CPU reports no device memory); "
            "using batch=16")
        return 16
    torch.cuda.empty_cache()
    if not limit_bytes:
        free, _ = torch.cuda.mem_get_info(device)
        limit_bytes = float(free + torch.cuda.memory_reserved(device))
    if reserve_bytes:
        log(f"[autobatch] {reserve_bytes / 1024**3:.2f} GiB of the "
            f"{limit_bytes / 1024**3:.1f} GiB limit kept for the train set on the device")
        limit_bytes -= reserve_bytes
    mems = tuple(probe_path_bytes(make_state, imgsz, b, max_boxes, graphed, evaluate)
                 for b in probe)
    picked = fit_and_pick(probe, mems, limit_bytes, fraction=fraction, cap=CAP)
    if picked < 1:
        picked = 1
        log("[autobatch] even batch=1 may exceed the memory budget; "
            "consider remat=True or a smaller imgsz")
    slope = (mems[1] - mems[0]) / (probe[1] - probe[0])
    log(f"[autobatch] {mems[0] / 1024**3:.2f}/{mems[1] / 1024**3:.2f} GiB at "
        f"b={probe[0]}/{probe[1]} (~{slope / 1024**2:.0f} MiB/img), limit "
        f"{limit_bytes / 1024**3:.1f} GiB x{fraction:.0%} -> batch {picked}")
    return picked

"""Phase stamps of the train step: the CUDA kernel's wrapper and its ring.

Replaces no TPU kernel (``csrc/phase_stamp.cu`` says why). A ``Ring`` holds
``RING_STEPS`` rows of ``len(STAMPS)`` u64 device timestamps and a step count,
on one device. ``ring(slot)`` launches the one-thread stamp kernel of
``slot`` on the current stream: it writes the card's nanosecond timer into
the current step's row, and the last slot's stamp advances the count.
Captured into a CUDA graph, the stamps fire at each replay, each step into
its own row. Slot i opens ``PHASES[i]``; the last closes the step. The
kernel of slot i is named ``dyd_stamp_<i>_<phase>`` (``STAMPS``), so a
profiler trace names the phase.

``phase_ms()`` reads the ring with one device-to-host copy -> each phase's
median milliseconds over the ring's last steps. On the CPU a
stamp does nothing and ``phase_ms()`` is None.

``ring.mark()`` launches the loss phase's mark ``MARK``, an empty kernel
between YOLOv10's two heads' assignments whose name is outside the stamps'
pattern: a point on the profiler's timeline (the benchmark reads the
one-to-one head's loss from it to stamp 3).

``launches`` counts the stamp launches and ``mark_launches`` the mark's, a
CUDA graph's at each replay (``_build.count_launch``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from . import _build

launches = 0
mark_launches = 0
MARK = "dyd_mark_loss_o2o"

PHASES = ("augment", "forward", "loss", "backward", "optimizer")
STAMPS = tuple(f"dyd_stamp_{i}_{p}" for i, p in enumerate(PHASES + ("end",)))
RING_STEPS = 64
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_MARK_ARGS = [ctypes.c_void_p]


class Ring:
    """The stamps of the last ``steps`` steps on ``device``; see the module
    docstring."""

    def __init__(self, device: torch.device):
        self.device, self.steps = torch.device(device), RING_STEPS
        self.buf = None
        if self.device.type == "cuda":  # rows, then the step count
            self.buf = torch.zeros(self.steps * len(STAMPS) + 1, dtype=torch.int64,
                                   device=self.device)

    def __call__(self, slot: int) -> None:
        if self.buf is None:
            return
        fn = _build.function("phase_stamp", "phase_stamp", _ARGS)
        with torch.cuda.device(self.device):
            err = fn(self.buf.data_ptr(), self.steps, int(slot),
                     torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"phase_stamp launch (slot {slot})")
        _build.count_launch(__name__)

    def mark(self) -> None:
        """The loss mark (``MARK``) on the current stream."""
        if self.buf is None:
            return
        fn = _build.function("phase_stamp", "phase_mark", _MARK_ARGS)
        with torch.cuda.device(self.device):
            err = fn(torch.cuda.current_stream().cuda_stream)
        _build.check(err, "phase_stamp mark launch")
        _build.count_launch(__name__, "mark_launches")

    def phase_ms(self) -> Optional[Dict[str, float]]:
        """Each phase's median device milliseconds over the ring's last steps
        (None on the CPU or before a whole step)."""
        if self.buf is None:
            return None
        return ring_phase_ms(self.buf.cpu().numpy(), self.steps)


def ring_phase_ms(host: np.ndarray, steps: int) -> Optional[Dict[str, float]]:
    """``Ring.phase_ms`` of a ring read to the host."""
    count = int(host[-1])
    n = min(count, steps)
    if n == 0:
        return None
    rows = [(count - n + i) % steps for i in range(n)]
    t = host[:-1].reshape(steps, len(STAMPS))[rows]
    ms = np.median(np.diff(t, axis=1).astype(np.float64), axis=0) / 1e6
    return {p: float(v) for p, v in zip(PHASES, ms)}


def skip(slot: int) -> None:
    """A stamp that stamps nothing (the eager step outside a step program)."""

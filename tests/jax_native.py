"""The JAX package's native scanner (``deal_yolo_daya_tpu.runtime``), loaded
for the port's tests that hold the port against it.

That runtime builds ``liblabelscan.so`` in place on first use (the file is
git-ignored, so a fresh checkout has none) under a lock of its own process
only. Test workers that start together compile into the same path at once;
one may load a half-written file, and then takes the pure-Python fallbacks
for the rest of its run. ``loaded()`` takes an inter-process lock on the
source, and where this process's load failed while another was writing the
file, clears the failure and loads again once the file is whole.
"""

from __future__ import annotations

import fcntl
import time

from deal_yolo_daya_tpu import runtime as jax_rt

TRIES = 20
PAUSE_S = 0.5


def loaded():
    """The JAX runtime's ctypes library, or None where it cannot be built."""
    with open(jax_rt._HERE / "labelscan.cpp", "rb") as src:
        fcntl.flock(src, fcntl.LOCK_EX)
        try:
            for _ in range(TRIES):
                lib = jax_rt.get_lib()
                if lib is not None:
                    return lib
                jax_rt._BUILD_FAILED = False
                time.sleep(PAUSE_S)
            return None
        finally:
            fcntl.flock(src, fcntl.LOCK_UN)

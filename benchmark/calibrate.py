#!/usr/bin/env python3
"""Readings that the limits in ``benchmark/workloads/*.json`` are set from:
the numbers a cell compares, for the program on many seeds, for the
control (the reference in fp8 in the program's place) and for the program
with a fault planted, all in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds 2 \
        --modes program --seeds 11 12 13 ...
    python3 benchmark/calibrate.py --workload <cell> \
        --modes control half_batch weight_lr_column --seeds 21 22 23

A mode is ``program``, ``control`` or a fault of ``lib/faults.py``; each
mode runs on every seed. Prints one JSON line a run: the mode, the seed
and each compared number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as R  # noqa: E402
from benchmark.lib import faults  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--modes", nargs="+", default=["program"],
                    choices=["program", "control", *faults.FAULTS])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    R.setup_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    for mode, seed in ((m, s) for m in args.modes for s in args.seeds):
        plant = faults.FAULTS[mode]() if mode in faults.FAULTS else contextlib.nullcontext()
        with plant:
            ctx = R.execute(args.workload, seed, args.seconds, False,
                            control="fp8" if mode == "control" else None)
        print(json.dumps({"mode": mode, "seed": seed, "readings": ctx.readings,
                          "e2e": ctx.e2e, "counters": {k: v for k, v in ctx.counters.items()
                                                       if isinstance(v, (int, float))}}),
              flush=True)
        del ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

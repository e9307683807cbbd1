#!/usr/bin/env python3
"""Time the graphed train step of two checkouts on one card, in turn.

    python3 tools/time_step_graph_torch.py OLD_TREE NEW_TREE [--rounds 2]

Runs ``chip_smoke.graph_vs_eager`` (phase 22: yolo11n at b32 and yolo12n at
b8, 640, bf16, the device cache and the on-card augmentation; 8 steps
through the step program and 8 eagerly, from one state) from each tree's
root in a process of its own, in the order old, new, new, old (``--rounds``
such pairs), and prints each run's wall, host (the enqueue) and CUDA-event
ms a step, graphed and eager, then the medians by tree, as one JSON line.
Each tree builds its own kernels; the card's name and power limit come
with the numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

MODELS = (("yolo11n", 32, (1, 1)), ("yolo12n", 8, (8, 8)))


def one(tree: Path) -> None:
    sys.path.insert(0, str(tree))
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {}
    for model, batch, per_step in MODELS:
        rec = chip_smoke.graph_vs_eager(0, model, batch, per_step, card)
        out[model] = {way: {k: rec[way][k] for k in ("wall_ms", "host_ms", "events_ms")}
                      for way in ("graphed", "eager")}
    print(json.dumps({"tree": str(tree), "card": card, "steps": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", type=Path)
    args = ap.parse_args()
    if args.one:
        one(args.one.resolve())
        return 0
    old, new = (t.resolve() for t in args.trees)
    runs = []
    for _ in range(args.rounds):
        for tree in (old, new, new, old):
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                                   str(tree)], cwd=tree, capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                print(proc.stdout[-4000:])
                raise SystemExit(f"{tree}: exit {proc.returncode}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    medians = {}
    for tree in (old, new):
        mine = [r["steps"] for r in runs if r["tree"] == str(tree)]
        medians[str(tree)] = {
            model: {way: {k: statistics.median(m[model][way][k] for m in mine)
                          for k in ("wall_ms", "host_ms", "events_ms")}
                    for way in ("graphed", "eager")}
            for model, _, _ in MODELS}
    print(json.dumps({"medians": medians, "card": runs[0]["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

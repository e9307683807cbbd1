"""The synth yardstick for the PyTorch port's Trainer: yolo11n trained for 30
epochs at imgsz 320, batch 32, on the shapes dataset of
``tools/synth_dataset_torch.py`` (600 train and 100 val images at 320 px,
seed 0), with the Trainer's defaults otherwise (mosaic, close_mosaic 10,
SGD lr0 0.01, 3 warmup epochs, the dataset on the card, on-card
augmentation, validation after each epoch). It runs the graphed step
(``steps_per_dispatch`` auto) and the eager step (``steps_per_dispatch=1``)
and prints one JSON line a run with the final mAP50 and mAP50-95, each
epoch's mAP50 and wall (validation included) and the card.

    python3 tools/train_synth_torch.py [--runs graphed,eager] [--epochs 30] [--root DIR]

Needs a CUDA card. The JAX package reached mAP50 0.988 / mAP50-95 0.974 on
its own yardstick (cv2 shapes written as JPEG, 2016/300 images); this
dataset is PNG and rasterised by numpy.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPD = {"graphed": None, "eager": 1}


def dataset(root: Path, n_train: int = 600, n_val: int = 100, imgsz: int = 320,
            seed: int = 0) -> Path:
    """The yardstick's data.yaml under ``root``, written once."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from synth_dataset_torch import generate

    out = root / f"shapes{n_train}_{imgsz}"
    if (out / "data.yaml").exists():
        return out / "data.yaml"
    return generate(out, n_train, n_val, imgsz, seed)


def run(data_yaml: Path, root: Path, mode: str, epochs: int = 30, imgsz: int = 320,
        seed: int = 0, device: str = "0") -> dict:
    """One yardstick run on ``device`` -> its record."""
    sys.path.insert(0, str(ROOT))
    from deal_yolo_daya_tpu_torch.train.trainer import train_run

    t0 = time.perf_counter()
    result = train_run("yolo11n", str(data_yaml), epochs=epochs, imgsz=imgsz, batch=32,
                       seed=seed, device=device, steps_per_dispatch=SPD[mode],
                       project=str(root / "runs"), name=mode, exist_ok=True)
    wall = time.perf_counter() - t0
    with open(Path(result["save_dir"]) / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    times = [0.0] + [float(r["time"]) for r in rows]
    return {"mode": mode, "epochs": len(rows), "wall_s": wall,
            "save_dir": str(result["save_dir"]),
            "map50": result["metrics"]["map50"], "map": result["metrics"]["map"],
            "map50_by_epoch": [float(r["metrics/mAP50(B)"]) for r in rows],
            "epoch_s": [b - a for a, b in zip(times, times[1:])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="graphed,eager")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--root", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_synth_torch: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="synth_") as tmp:
        root = Path(args.root or tmp)
        t0 = time.perf_counter()
        data_yaml = dataset(root)
        print(f"dataset {data_yaml} in {time.perf_counter() - t0:.1f} s", flush=True)
        for mode in args.runs.split(","):
            print(json.dumps({**run(data_yaml, root, mode, args.epochs), "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

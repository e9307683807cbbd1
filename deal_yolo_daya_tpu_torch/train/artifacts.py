"""The run directory of a training run and its tables.

Counterpart of ``RunDir`` in ``deal_yolo_daya_tpu/train/artifacts.py``: the
``project/name`` directory with the ultralytics auto-increment (``train``,
``train2``, ...), ``args.yaml`` and ``results.csv`` with the same 15 columns,
which the results page reads. The plots of the JAX package (results.png,
confusion matrices, PR/F1 curves, val_batch images) are not ported yet.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List

import yaml

RESULTS_COLUMNS = [
    "epoch", "time",
    "train/box_loss", "train/cls_loss", "train/dfl_loss",
    "metrics/precision(B)", "metrics/recall(B)",
    "metrics/mAP50(B)", "metrics/mAP50-95(B)",
    "val/box_loss", "val/cls_loss", "val/dfl_loss",
    "lr/pg0", "lr/pg1", "lr/pg2",
]


class RunDir:
    """One training run's directory, with ``weights/`` inside."""

    def __init__(self, project: str, name: str = "train", exist_ok: bool = False):
        base = Path(project)
        run = base / name
        if run.exists() and not exist_ok:
            i = 2
            while (base / f"{name}{i}").exists():
                i += 1
            run = base / f"{name}{i}"
        run.mkdir(parents=True, exist_ok=True)
        (run / "weights").mkdir(exist_ok=True)
        self.path = run
        self._rows: List[Dict] = []

    @classmethod
    def at(cls, path) -> "RunDir":
        """The run directory at ``path``, made already (by rank 0 of a
        data-parallel run): nothing is created."""
        run = cls.__new__(cls)
        run.path, run._rows = Path(path), []
        return run

    def write_args(self, args: Dict):
        clean = {k: (str(v) if isinstance(v, Path) else v) for k, v in args.items()}
        (self.path / "args.yaml").write_text(
            yaml.dump(clean, sort_keys=False, allow_unicode=True), encoding="utf-8")

    def append_results_row(self, row: Dict):
        """Add one epoch's row and rewrite ``results.csv``."""
        self._rows.append(row)
        with open(self.path / "results.csv", "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=RESULTS_COLUMNS)
            writer.writeheader()
            for r in self._rows:
                writer.writerow({c: _fmt(r.get(c, 0)) for c in RESULTS_COLUMNS})


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.5f}"
    return str(v)

"""The run directory of a training run: its tables and plots.

Counterpart of ``RunDir`` in ``deal_yolo_daya_tpu/train/artifacts.py``: the
``project/name`` directory with the ultralytics auto-increment (``train``,
``train2``, ...), ``args.yaml``, ``results.csv`` with the same 15 columns,
and the plots the results page reads, with the JAX package's file names,
figure sizes, dpi, panels and labels: ``results.png``,
``confusion_matrix.png`` and ``confusion_matrix_normalized.png``,
``PR_curve.png``, ``F1_curve.png``, ``P_curve.png`` and ``R_curve.png``
(matplotlib), and ``val_batch{N}_pred.jpg`` / ``val_batch{N}_labels.jpg``
(PIL).

matplotlib is imported when a plot is drawn. Where it is not installed
(the card machines this port runs on) its files are skipped, and the first
skip prints one line naming them; the JAX package raises ImportError there.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import yaml

MATPLOTLIB_FILES = ("results.png", "confusion_matrix.png", "confusion_matrix_normalized.png",
                    "PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png")

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
        self._no_matplotlib = False

    @classmethod
    def at(cls, path) -> "RunDir":
        """The run directory at ``path``, made already (by rank 0 of a
        parallel run): nothing is created."""
        run = cls.__new__(cls)
        run.path, run._rows, run._no_matplotlib = Path(path), [], False
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

    # ------------------------------------------------------------------ plots

    def _pyplot(self):
        """matplotlib.pyplot on the Agg backend, or None without matplotlib
        (the first time, one line names the files that are not written)."""
        try:
            import matplotlib
        except ImportError:
            if not self._no_matplotlib:
                self._no_matplotlib = True
                print(f"matplotlib is not installed: {', '.join(MATPLOTLIB_FILES)} not written "
                      f"in {self.path}")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def plot_results(self):
        """results.png: ten panels of the results.csv columns by epoch."""
        plt = self._pyplot()
        if plt is None or not self._rows:
            return
        epochs = [r["epoch"] for r in self._rows]
        panels = [
            ("train/box_loss", "train/box_loss"),
            ("train/cls_loss", "train/cls_loss"),
            ("train/dfl_loss", "train/dfl_loss"),
            ("metrics/precision(B)", "precision"),
            ("metrics/recall(B)", "recall"),
            ("val/box_loss", "val/box_loss"),
            ("val/cls_loss", "val/cls_loss"),
            ("val/dfl_loss", "val/dfl_loss"),
            ("metrics/mAP50(B)", "mAP50"),
            ("metrics/mAP50-95(B)", "mAP50-95"),
        ]
        fig, axes = plt.subplots(2, 5, figsize=(18, 7))
        for ax, (col, title) in zip(axes.flat, panels):
            ax.plot(epochs, [float(r.get(col, 0)) for r in self._rows], marker=".")
            ax.set_title(title, fontsize=9)
        fig.tight_layout()
        fig.savefig(self.path / "results.png", dpi=120)
        plt.close(fig)

    def plot_confusion_matrix(self, mat: np.ndarray, names: Sequence[str]):
        """confusion_matrix.png and its column-normalised twin: rows the
        predicted class, columns the true one, background last."""
        plt = self._pyplot()
        if plt is None:
            return
        labels = list(names) + ["background"]
        for normalized, fname in ((False, "confusion_matrix.png"),
                                  (True, "confusion_matrix_normalized.png")):
            data = mat.astype(np.float64)
            if normalized:
                data = data / np.maximum(data.sum(0, keepdims=True), 1e-9)
            fig, ax = plt.subplots(figsize=(8, 7))
            im = ax.imshow(data, cmap="Blues")
            ax.set_xticks(range(len(labels)))
            ax.set_yticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=90, fontsize=7)
            ax.set_yticklabels(labels, fontsize=7)
            ax.set_xlabel("True")
            ax.set_ylabel("Predicted")
            fig.colorbar(im, ax=ax)
            fig.tight_layout()
            fig.savefig(self.path / fname, dpi=120)
            plt.close(fig)

    def plot_pr_curves(self, metrics_result: Dict, names: Sequence[str]):
        """PR/F1/P/R curve PNGs in the ultralytics layout: a thin line a
        class (up to 20 classes, grey beyond) and a bold all-classes mean."""
        curves = metrics_result.get("curves")
        if not curves or curves["py"].size == 0:
            return
        px = curves["px"]
        cls_names = [names[c] if 0 <= c < len(names) else str(c) for c in curves["classes"]]
        aps = metrics_result.get("per_class_ap")
        pr_labels = [f"{n} {aps[c, 0]:.3f}" if aps is not None else n
                     for n, c in zip(cls_names, curves["classes"])]
        self._curve_plot(px, curves["py"], pr_labels, "Recall", "Precision", "PR_curve.png",
                         mean_label=f"all classes {metrics_result.get('map50', 0):.3f} mAP@0.5")
        for key, ylabel, fname in (("f1", "F1", "F1_curve.png"),
                                   ("p", "Precision", "P_curve.png"),
                                   ("r", "Recall", "R_curve.png")):
            y = curves[key]
            mean = y.mean(0)
            i = int(mean.argmax())
            self._curve_plot(px, y, cls_names, "Confidence", ylabel, fname,
                             mean_label=f"all classes {mean[i]:.2f} at {px[i]:.3f}")

    def _curve_plot(self, x, ys, labels, xlabel, ylabel, fname, mean_label):
        plt = self._pyplot()
        if plt is None:
            return
        fig, ax = plt.subplots(figsize=(9, 6), tight_layout=True)
        if len(ys) <= 20:
            for y, label in zip(ys, labels):
                ax.plot(x, y, linewidth=1, label=label)
        else:
            for y in ys:
                ax.plot(x, y, linewidth=1, color="grey", alpha=0.4)
        ax.plot(x, ys.mean(0), linewidth=3, color="blue", label=mean_label)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_title(f"{ylabel}-{xlabel} Curve")
        ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left", fontsize=7)
        fig.savefig(self.path / fname, dpi=120, bbox_inches="tight")
        plt.close(fig)

    def save_val_batch_predictions(self, images: np.ndarray, boxes: np.ndarray,
                                   scores: Optional[np.ndarray], classes: np.ndarray,
                                   num_det: np.ndarray, names: Sequence[str],
                                   batch_idx: int = 0, max_images: int = 9):
        """val_batch{N}_pred.jpg (red boxes with their confidence) or, with
        ``scores`` None, val_batch{N}_labels.jpg (green GT boxes): up to
        ``max_images`` of the (B, S, S, 3) 0-255 ``images`` tiled, with
        ``num_det[i]`` of the (B, K, 4) xyxy ``boxes`` and ``classes`` on
        image i."""
        from PIL import Image, ImageDraw

        is_pred = scores is not None
        color = (255, 64, 64) if is_pred else (64, 200, 64)
        b = min(len(images), max_images)
        tile = int(np.ceil(np.sqrt(b)))
        s = images.shape[1]
        canvas = Image.new("RGB", (tile * s, tile * s), (50, 50, 50))
        for i in range(b):
            img = Image.fromarray(images[i].astype(np.uint8))
            draw = ImageDraw.Draw(img)
            for d in range(int(num_det[i])):
                x1, y1, x2, y2 = boxes[i, d]
                cls_id = int(classes[i, d])
                label = names[cls_id] if 0 <= cls_id < len(names) else str(cls_id)
                if is_pred:
                    label = f"{label} {scores[i, d]:.2f}"
                draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
                draw.text((x1 + 2, max(y1 - 12, 0)), label, fill=(255, 255, 0))
            canvas.paste(img, ((i % tile) * s, (i // tile) * s))
        suffix = "pred" if is_pred else "labels"
        canvas.save(self.path / f"val_batch{batch_idx}_{suffix}.jpg", quality=88)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.5f}"
    return str(v)

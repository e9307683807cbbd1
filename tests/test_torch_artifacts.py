"""The run directory's plots on the CPU: the port's ``RunDir`` against the
JAX package's on identical numpy inputs (the same file set, equal decoded
pixels: exact), ``Trainer.validate(save_artifacts=True)``'s files, and the
run without matplotlib (one printed line names the files not written; the
PIL val_batch images are written all the same)."""

import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from deal_yolo_daya_tpu_torch.train import artifacts as port_artifacts
from deal_yolo_daya_tpu_torch.train.metrics import DetMetrics, confusion_matrix
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

CURVES = {"PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"}
MATRICES = {"confusion_matrix.png", "confusion_matrix_normalized.png"}


def _rows(rng, epochs=3):
    return [{"epoch": e + 1, "time": 1.0 + e, **{c: float(rng.uniform(0, 2))
                                                 for c in port_artifacts.RESULTS_COLUMNS[2:]}}
            for e in range(epochs)]


def _metrics(rng, nc):
    """A DetMetrics result over random images with overlapping boxes."""
    dm = DetMetrics(nc=nc)
    preds, gts = [], []
    for _ in range(12):
        gb = rng.uniform(0, 60, (5, 4)).astype(np.float32)
        gb[:, 2:] += gb[:, :2] + 4
        gc = rng.integers(0, nc, 5)
        pb = (gb + rng.normal(0, 2, gb.shape)).astype(np.float32)
        ps = rng.uniform(0.05, 1, 5).astype(np.float32)
        pc = np.where(rng.uniform(size=5) < 0.8, gc, rng.integers(0, nc, 5))
        dm.update(pb, ps, pc, gb, gc)
        preds.append((pb, ps, pc))
        gts.append((gb, gc))
    return dm.compute(), confusion_matrix(preds, gts, nc)


def _batch(rng, b=5, s=64, k=6):
    images = rng.integers(0, 256, (b, s, s, 3)).astype(np.uint8)
    boxes = rng.uniform(0, s / 2, (b, k, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] + 4
    return (images, boxes, rng.uniform(0, 1, (b, k)).astype(np.float32),
            rng.integers(0, 3, (b, k)), rng.integers(0, k + 1, b))


def _draw_all(run, seed, nc):
    rng = np.random.default_rng(seed)
    names = [f"class{i}" for i in range(nc)]
    run._rows = _rows(rng)
    run.plot_results()
    result, mat = _metrics(rng, nc)
    run.plot_confusion_matrix(mat, names)
    run.plot_pr_curves(result, names)
    images, boxes, scores, classes, num = _batch(rng)
    run.save_val_batch_predictions(images, boxes, scores, classes, num, names, batch_idx=0)
    run.save_val_batch_predictions(images, boxes, None, classes, num, names, batch_idx=0)
    return result


def _pixels(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


@pytest.mark.parametrize("nc", [3, 24])  # 24: more than 20 classes, grey lines, no legend rows
def test_plots_equal_jax_pixel_for_pixel(tmp_path, nc):
    from deal_yolo_daya_tpu.train.artifacts import RunDir as JaxRunDir

    jax_run = JaxRunDir(str(tmp_path / "jax"), "run")
    port_run = port_artifacts.RunDir(str(tmp_path / "port"), "run")
    result = _draw_all(jax_run, 5, nc)
    _draw_all(port_run, 5, nc)
    assert (len(result["curves"]["classes"]) > 20) == (nc > 20)
    files = sorted(p.name for p in jax_run.path.iterdir() if p.is_file())
    assert files == sorted(p.name for p in port_run.path.iterdir() if p.is_file())
    assert set(files) == {"results.png", *MATRICES, *CURVES, "val_batch0_pred.jpg",
                          "val_batch0_labels.jpg"}
    assert set(files) - {"val_batch0_pred.jpg", "val_batch0_labels.jpg"} == \
        set(port_artifacts.MATPLOTLIB_FILES)
    for name in files:
        want, got = _pixels(jax_run.path / name), _pixels(port_run.path / name)
        assert got.shape == want.shape and np.array_equal(got, want), name


def test_no_curves_without_gt(tmp_path):
    """No class with GT: no curve files (the JAX rule), the matrices still."""
    run = port_artifacts.RunDir(str(tmp_path), "run")
    empty = DetMetrics(nc=2)
    empty.update(np.zeros((1, 4), np.float32) + [0, 0, 5, 5], np.ones(1, np.float32),
                 np.zeros(1, np.int64), np.zeros((0, 4), np.float32), np.zeros(0, np.int64))
    run.plot_pr_curves(empty.compute(), ["a", "b"])
    run.plot_confusion_matrix(np.zeros((3, 3), np.int64), ["a", "b"])
    assert sorted(p.name for p in run.path.iterdir() if p.is_file()) == sorted(MATRICES)


def _small_trainer(tmp_path, name):
    from tests.test_torch_port_trainer import _small

    return _small(tmp_path, name)


def _val_images(n_batches):
    return {f"val_batch{i}_{kind}.jpg" for i in range(min(n_batches, 3))
            for kind in ("pred", "labels")}


def test_validate_save_artifacts_writes_the_jax_set(tmp_path):
    """validate(save_artifacts=True): the val_batch pair of each of the
    first three batches, the confusion matrices and the four curves (the
    JAX Trainer's set without results.png, which the end of train() adds);
    a plain validate() writes none of them and returns the same metrics."""
    trainer = _small_trainer(tmp_path, "val")
    plain, _ = trainer.validate()
    before = {p.name for p in trainer.run.path.iterdir() if p.is_file()}
    metrics, _ = trainer.validate(save_artifacts=True)
    after = {p.name for p in trainer.run.path.iterdir() if p.is_file()}
    assert before == {"args.yaml"}
    n_batches = len(trainer.val_loader)
    assert n_batches == 1
    assert after - before == _val_images(n_batches) | MATRICES | CURVES
    for k in ("precision", "recall", "map50", "map"):
        assert metrics[k] == plain[k], k


def test_without_matplotlib_one_line_and_the_jpgs(tmp_path, monkeypatch, capsys):
    """matplotlib's import fails: one printed line names the seven files
    not written, the run goes on, and the val_batch jpgs are written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    trainer = _small_trainer(tmp_path, "nompl")
    capsys.readouterr()
    trainer.validate(save_artifacts=True)
    trainer.run.append_results_row({"epoch": 1})
    trainer.run.plot_results()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "matplotlib" in ln]
    assert lines == [f"matplotlib is not installed: "
                     f"{', '.join(port_artifacts.MATPLOTLIB_FILES)} not written in "
                     f"{trainer.run.path}"]
    files = {p.name for p in Path(trainer.run.path).iterdir() if p.is_file()}
    assert files == {"args.yaml", "results.csv"} | _val_images(len(trainer.val_loader))

"""The port's Trainer alone on the CPU, whole runs: single_cls, fraction and
patience; freeze; two epochs against one epoch and a resume; checkpoint
pruning (keep_last) and save_json. A yolo11n at 64 px, f32, on
tests/test_data.py's dataset (``tests/test_torch_port_trainer.py::_small``)."""

import json

import pytest
import torch

from tests.test_data import make_dataset
from tests.test_torch_port_trainer import _rows, _small
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two CPU threads for this file's PyTorch ops, restored afterwards: the
    test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_single_cls_fraction_and_patience(tmp_path):
    """single_cls folds every label into class 0 named "item"; fraction
    keeps the leading share of the train set; with lr 0 the fitness never
    improves, so patience 1 stops after the second epoch."""
    t = _small(tmp_path, "sc", single_cls=True, fraction=0.5, epochs=3, patience=1, lr0=0.0,
               warmup_epochs=0)
    assert (t.nc, t.names, len(t.train_ds)) == (1, ["item"], 4)
    assert all((lab[:, 0] == 0).all() for lab in t.train_ds.labels + t.val_ds.labels)
    assert any(len(lab) for lab in t.val_ds.labels)
    t.train()
    assert [r["epoch"] for r in _rows(t.run.path)] == ["1", "2"]


def test_freeze_keeps_frozen_parameters_and_moves_their_statistics(tmp_path):
    t = _small(tmp_path, "freeze", freeze=3)
    assert t.frozen == ("0", "1", "2")
    before = {k: v.clone() for k, v in t.state.model.state_dict().items()}
    t.train()
    after = t.state.model.state_dict()
    moved = 0
    for name, p in t.state.model.named_parameters():
        frozen = name.split(".")[0] in t.frozen
        assert p.requires_grad != frozen, name
        if frozen:
            assert torch.equal(p, before[name]), name
        else:  # a leaf whose gradient is 0 (a box branch without GT) may stay
            moved += not torch.equal(p, before[name])
    assert moved > 100
    assert not torch.equal(after["0.bn.running_mean"], before["0.bn.running_mean"])


def test_two_epochs_equal_one_epoch_resume_one_epoch(tmp_path):
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    kw = dict(epochs=2, close_mosaic=1, mosaic=1.0)
    whole = _small(tmp_path, "whole", data_yaml, **kw)
    whole.train()
    first = _small(tmp_path, "first", data_yaml, time=1e-9, **kw)  # stops after epoch 1
    first.train()
    assert len(_rows(first.run.path)) == 1
    second = _small(tmp_path, "second", data_yaml,
                    resume=str(first.run.path / "weights" / "last.pt"), **kw)
    assert second.start_epoch == 1 and second.state.updates == 2
    second.train()
    want, got = whole.state.state(), second.state.state()
    for part in ("model", "ema"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    mom_w = [s["momentum_buffer"] for s in want["optimizer"]["optimizer"]["state"].values()]
    mom_g = [s["momentum_buffer"] for s in got["optimizer"]["optimizer"]["state"].values()]
    assert all(torch.equal(a, b) for a, b in zip(mom_w, mom_g))
    row_w, row_g = _rows(whole.run.path)[1], _rows(second.run.path)[0]
    for col in row_w:
        if col != "time":
            assert row_g[col] == row_w[col], col


def test_keep_last_and_save_json(tmp_path):
    t = _small(tmp_path, "gc", epochs=4, save_period=1, keep_last=2, save_json=True, val_period=2)
    t.train()
    names = sorted(p.name for p in (t.run.path / "weights").iterdir())
    assert names == ["best.pt", "epoch3.pt", "epoch4.pt", "last.pt"]
    rows = _rows(t.run.path)
    assert [r["epoch"] for r in rows] == ["1", "2", "3", "4"]
    assert float(rows[0]["val/cls_loss"]) == 0 and float(rows[1]["val/cls_loss"]) > 0
    records = json.loads((t.run.path / "predictions.json").read_text())
    assert records and set(records[0]) == {"image_id", "category_id", "bbox", "score"}
    assert {r["image_id"] for r in records} <= {0, 1, 2, 3}

"""Two repairs of the port's api against the JAX package: ``YOLO.load``
takes ``ckpt_path`` (JAX api.py ``load(self, ckpt_path)``), and
``Detections.plot`` labels in the JAX package's font chooser
(``datakit.visualize._get_font``: simhei.ttf, then Arial Unicode.ttf, then
PIL's default), at size 14."""

import numpy as np
import pytest
import torch
from PIL import ImageFont

from deal_yolo_daya_tpu.datakit import visualize as jax_visualize
from deal_yolo_daya_tpu_torch import api
from deal_yolo_daya_tpu_torch.api import YOLO, Detections
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.test_data import make_dataset
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401


def test_load_takes_ckpt_path(tmp_path):
    data_yaml = make_dataset(tmp_path, n_train=4, n_val=2, imgsz=64, nc=3)
    trainer = Trainer(TrainConfig(model="yolo11n", data=str(data_yaml), imgsz=64, batch=4,
                                  amp=False, device="cpu", project=str(tmp_path / "runs"),
                                  async_ckpt=False, max_boxes=8, workers=1))
    trainer.save_checkpoint("last", 0, 0.0)
    path = trainer.run.path / "weights" / "last.pt"
    handle = YOLO("yolov8n", nc=80, imgsz=64, device="cpu").load(ckpt_path=path)
    assert (handle.family, handle.scale, handle.nc) == ("yolo11", "n", 3)
    want = {**trainer.state.state()["model"], **trainer.state.ema_state_dict()}
    for k, v in handle._model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(FileNotFoundError):
        YOLO("yolo11n", device="cpu").load(ckpt_path=tmp_path / "missing.pt")


def _tried(monkeypatch, pick):
    """Run ``pick()`` with ``ImageFont.truetype`` refusing every font file
    by name -> (the (name, size) pairs it tried, what it returned). PIL's
    own default font (bytes, not a name) still loads."""
    tried, truetype = [], ImageFont.truetype

    def refuse(name, size=10, *a, **k):
        if not isinstance(name, str):
            return truetype(name, size, *a, **k)
        tried.append((name, size))
        raise OSError(f"cannot open resource {name}")

    monkeypatch.setattr(ImageFont, "truetype", refuse)
    return tried, pick()


def test_label_font_tries_the_jax_fonts_in_order(monkeypatch):
    want, jfont = _tried(monkeypatch, lambda: jax_visualize._get_font(size=14))
    got, font = _tried(monkeypatch, lambda: api.label_font(size=14))
    assert got == want == [("simhei.ttf", 14), ("Arial Unicode.ttf", 14)]
    assert type(font) is type(jfont)  # both fall back to load_default()


def test_plot_draws_with_the_label_font_at_14(monkeypatch):
    tried, _ = _tried(monkeypatch, lambda: None)
    det = Detections("x.png", np.zeros((48, 64, 3), np.uint8),
                     np.array([[4.0, 20.0, 40.0, 44.0]], np.float32), np.array([0.9], np.float32),
                     np.array([1]), ["猫", "狗"])
    img = det.plot()
    assert tried == [("simhei.ttf", 14), ("Arial Unicode.ttf", 14)]
    assert img.shape == (48, 64, 3) and img.any()

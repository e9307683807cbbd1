"""The port's package rules and predict surface on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.device import resolve_device
from deal_yolo_daya_tpu_torch.models.registry import parse_model_spec

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import deal_yolo_daya_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [k for k in sys.modules if k in ("jax", "flax") or k.startswith(("jax.", "flax."))
       or k == "deal_yolo_daya_tpu" or k.startswith("deal_yolo_daya_tpu.")]
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("api", "models.blocks", "models.yolo11", "models.weights", "ops.nms",
                 "ops.kernels.area_attention", "ops.kernels.nms_suppress", "serve"):
        assert f"deal_yolo_daya_tpu_torch.{name}" in result["modules"]


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    bundle = YOLO("yolo11n", nc=3, imgsz=64, device="cpu").export(tmp_path / "bundle")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO("yolo11n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO.from_export(bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_defaults_follow_the_device():
    yolo = YOLO("yolo11n", device="cpu")
    assert yolo.dtype == torch.float32 and yolo.device == torch.device("cpu")
    assert parse_model_spec("yolo11s.yaml") == ("yolo11", "s")
    assert parse_model_spec("yolov8n") == ("yolov8", "n")  # every family of the registry
    assert (yolo.family, yolo.scale) == ("yolo11", "n")


def test_predict_file_directory_and_records(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in [(40, 70), (64, 50)]]
    for i, arr in enumerate(arrays):
        Image.fromarray(arr).save(tmp_path / f"im{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    yolo = YOLO("yolo11n", nc=3, imgsz=64, device="cpu")
    by_dir = yolo.predict(tmp_path, conf=0.0, batch_size=1)
    by_list = yolo.predict(arrays, conf=0.0, batch_size=4)
    by_file = yolo.predict(tmp_path / "im1.png", conf=0.0)
    assert [Path(d.path).name for d in by_dir] == ["im0.png", "im1.png"]
    assert by_dir[1].path == by_file[0].path
    for d, a in zip(by_dir, by_list):  # PNG is lossless: same pixels, same result
        np.testing.assert_allclose(d.boxes, a.boxes, atol=1e-4)
        assert len(d) > 0 and d.image.shape == a.image.shape
        h, w = d.image.shape[:2]
        assert (d.boxes[:, [0, 2]] <= w).all() and (d.boxes[:, [1, 3]] <= h).all()
        assert (d.boxes >= 0).all()
    rec = by_list[0].to_records()[0]
    assert set(rec) == {"name", "class", "confidence", "box"}
    assert json.loads(by_list[0].to_json())[0]["class"] == rec["class"]
    only = yolo.predict(arrays[0], conf=0.0, classes=[1])[0]
    assert set(only.classes.tolist()) <= {1}
    assert by_list[0].plot().shape == arrays[0].shape

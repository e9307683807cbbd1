"""The rest of the port's ``predict`` on the CPU, mirroring the JAX package's
tests/test_api.py: video files (cv2) with ``stream`` and ``save``, saved
images with distinct basenames and the auto-incremented ``runs/predict``,
http(s) URLs through the download cache, ``(label, array)`` items, and a
video's per-frame detections against JAX's ``predict`` on the same file."""

import io
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from deal_yolo_daya_tpu.api import YOLO as JaxYOLO
from deal_yolo_daya_tpu.models import build_yolo11 as jax_build_yolo11
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.datakit import download
from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

cv2 = pytest.importorskip("cv2")

IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two CPU threads: the suite runs several workers side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def model():
    return YOLO("yolo11n", nc=2, imgsz=IMGSZ, device="cpu")


def _write_video(path, frames, fps):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (frames.shape[2], frames.shape[1]))
    for f in frames:
        writer.write(f)
    writer.release()


def test_predict_video_stream_and_save(model, tmp_path):
    vid = tmp_path / "clip.mp4"
    _write_video(vid, np.random.default_rng(3).integers(0, 255, (5, 48, 80, 3), dtype=np.uint8),
                 12)
    gen = model.predict(vid, conf=0.001, max_det=5, batch_size=2, stream=True, save=True,
                        save_dir=tmp_path / "out")
    assert isinstance(gen, types.GeneratorType)  # stream=True is lazy
    dets = list(gen)
    assert [d.path for d in dets] == [f"{vid}#frame{i}" for i in range(5)]
    assert all(d.image.shape == (48, 80, 3) for d in dets)
    for d in dets:
        if len(d):
            assert (d.boxes[:, [0, 2]] <= 80).all() and (d.boxes[:, [1, 3]] <= 48).all()
    out = tmp_path / "out" / "clip_pred.mp4"
    assert all(d.save_path == out for d in dets) and out.stat().st_size > 0
    cap = cv2.VideoCapture(str(out))
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 12) < 0.5  # the source fps carried over
    cap.release()
    # the frames as decoded, as (label, array) items: the same detections
    cap = cv2.VideoCapture(str(vid))
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append((f"frame{len(frames)}", cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
    cap.release()
    by_array = model.predict(frames, conf=0.001, max_det=5, batch_size=2)
    assert [d.path for d in by_array] == [f"frame{i}" for i in range(5)]
    for a, d in zip(by_array, dets):
        np.testing.assert_array_equal(a.image, d.image)
        np.testing.assert_array_equal(a.boxes, d.boxes)
        np.testing.assert_array_equal(a.classes, d.classes)

    with pytest.raises(FileNotFoundError, match="视频文件不存在"):
        model.predict(tmp_path / "missing.mp4")
    (tmp_path / "bad.mp4").write_bytes(b"not a video")
    with pytest.raises(RuntimeError, match="无法打开视频"):
        model.predict(tmp_path / "bad.mp4")


def test_predict_video_without_cv2_raises(model, tmp_path, monkeypatch):
    vid = tmp_path / "clip.avi"
    vid.write_bytes(b"\0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        model.predict(vid)


def test_predict_image_save_and_stream(model, tmp_path):
    img = np.random.default_rng(4).integers(0, 255, (32, 40, 3), dtype=np.uint8)
    p = tmp_path / "a.png"
    Image.fromarray(img).save(p)
    dets = model.predict([str(p), img], conf=0.001, max_det=5, save=True,
                         save_dir=tmp_path / "pred")
    assert len(dets) == 2
    assert dets[0].save_path == tmp_path / "pred" / "a.png"
    assert dets[1].save_path == tmp_path / "pred" / "image1.jpg"
    assert all(d.save_path.stat().st_size > 0 for d in dets)
    streamed = model.predict([img], conf=0.001, max_det=5, stream=True)
    assert isinstance(streamed, types.GeneratorType)
    streamed = list(streamed)
    assert len(streamed) == 1 and streamed[0].save_path is None
    np.testing.assert_array_equal(streamed[0].boxes, dets[1].boxes)


def test_predict_save_name_collisions_and_default_dir(model, tmp_path, monkeypatch):
    img = np.random.default_rng(5).integers(0, 255, (32, 40, 3), dtype=np.uint8)
    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    d1.mkdir(), d2.mkdir()
    Image.fromarray(img).save(d1 / "same.png")
    Image.fromarray(img).save(d2 / "same.png")
    Image.fromarray(img).save(d1 / "image2.jpg")  # named like index 2's array fallback
    dets = model.predict([str(d1 / "same.png"), str(d2 / "same.png"), img,
                          str(d1 / "image2.jpg")],
                         conf=0.001, max_det=5, save=True, save_dir=tmp_path / "o")
    assert [d.save_path.name for d in dets] == ["same.png", "same_1.png", "image2.jpg",
                                                "image2_1.jpg"]
    assert all(d.save_path.stat().st_size > 0 for d in dets)
    monkeypatch.chdir(tmp_path)
    for want in ("predict", "predict2", "predict3"):
        got = model.predict([img], conf=0.001, max_det=5, save=True)
        assert got[0].save_path.parent.resolve() == (tmp_path / "runs" / want).resolve()


def test_predict_url_source(model, tmp_path, monkeypatch):
    requests = pytest.importorskip("requests")
    img = np.random.default_rng(1).integers(0, 255, (32, 40, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    calls = {"n": 0}

    class _Resp:
        content = buf.getvalue()

        def raise_for_status(self):
            pass

    def fake_get(url, stream=True, timeout=15):
        calls["n"] += 1
        return _Resp()

    monkeypatch.setattr(requests, "get", fake_get)
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    url = "http://host/remote_img.png"
    dets = model.predict(url, conf=0.99)
    assert len(dets) == 1 and calls["n"] == 1
    assert Path(dets[0].path) == tmp_path / "dyd_predict_cache" / "remote_img.png"
    np.testing.assert_array_equal(dets[0].image, img)  # PNG: the same pixels
    # a list mixing a URL with an array, and the cache hit: no second download
    dets2 = model.predict([url, img], conf=0.99)
    assert len(dets2) == 2 and calls["n"] == 1

    def dead_get(url, stream=True, timeout=15):
        raise IOError("no route")

    monkeypatch.setattr(requests, "get", dead_get)
    monkeypatch.setattr(download.time, "sleep", lambda s: None)
    with pytest.raises(FileNotFoundError, match="无法下载输入源"):
        model.predict("http://host/missing.jpg", conf=0.99)


def _perturb(tree, rng, path=()):
    """Random BN statistics and louder heads with class biases 0, so that
    conf 0.25 leaves detections (as tests/test_torch_port_model.py)."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if hasattr(v, "items"):
            out[k] = _perturb(v, rng, p)
            continue
        a = np.array(v, np.float32)
        if "bn" in p:
            lo, hi = {"scale": (0.8, 1.6), "bias": (-0.3, 0.3),
                      "mean": (-0.2, 0.2), "var": (0.5, 1.5)}[k]
            a = rng.uniform(lo, hi, a.shape).astype(np.float32)
        elif p[0] == "detect" and p[-2] in ("box0_2", "box1_2", "box2_2") and k == "kernel":
            a = a * 15.0
        elif p[0] == "detect" and p[-2] in ("cls0_2", "cls1_2", "cls2_2"):
            a = a * 10.0 if k == "kernel" else np.zeros_like(a)
        out[k] = a
    return out


def test_video_frames_match_jax_predict(tmp_path):
    """The same mp4 through JAX's predict and the port's, in f32: 64 x 48
    frames letterbox to 64 px by padding alone, so both feed the network the
    same canvases, and the boxes agree at test_torch_port_api.py's 1e-4."""
    vid = tmp_path / "clip.mp4"
    _write_video(vid, np.random.default_rng(8).integers(0, 255, (6, 48, 64, 3), dtype=np.uint8),
                 10)
    jmodel, variables = jax_build_yolo11("n", nc=2, imgsz=IMGSZ, dtype=jnp.float32)
    rng = np.random.default_rng(12)
    variables = {c: _perturb(variables[c], rng) for c in ("params", "batch_stats")}
    jyolo = JaxYOLO("yolo11n", nc=2, imgsz=IMGSZ)
    jyolo._model, jyolo._variables = jmodel, variables
    want = jyolo.predict(vid, conf=0.25, batch_size=4)
    yolo = YOLO("yolo11n", nc=2, imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    yolo._ensure_built().load_state_dict(state_dict_from_jax(variables), strict=True)
    got = yolo.predict(vid, conf=0.25, batch_size=4)
    assert [d.path for d in got] == [d.path for d in want]
    assert sum(len(d) for d in want) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.classes, w.classes)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-4)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-4)

"""The port's serving Engine, HTTP frontend, export/from_export, val and
letterbox_batch against the JAX package, on the CPU: yolo11n at 64 px, nc 3,
f32, with weights carried over from a JAX tree by ``state_dict_from_jax``,
and images (48 + 4i, 64, 3) u8 so that the letterbox is only padding in
both packages."""

import json
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deal_yolo_daya_tpu.api import YOLO as JaxYOLO
from deal_yolo_daya_tpu.models import build_yolo11 as jax_build_yolo11
from deal_yolo_daya_tpu.models.yolo11 import fuse_conv_bn as jax_fuse_conv_bn
from deal_yolo_daya_tpu.ops.letterbox import letterbox_batch as jax_letterbox_batch
from deal_yolo_daya_tpu.serve import Engine as JaxEngine
from deal_yolo_daya_tpu.serve import ServeStats as JaxServeStats
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.ops import letterbox_batch
from deal_yolo_daya_tpu_torch.ops.letterbox import letterbox_numpy
from deal_yolo_daya_tpu_torch.ops.png import write_png
from deal_yolo_daya_tpu_torch.serve import (Engine, ServeStats, UndecodableImage,
                                            decode_image, serve_http)
from deal_yolo_daya_tpu_torch.train.trainer import Trainer, make_config
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

IMGSZ = 64
NC = 3
CONF, IOU = 0.25, 0.7


def _perturb(tree, rng, path=()):
    """Random BN statistics and louder head outputs, so that random-init
    outputs are not degenerate; class biases 0 so that conf 0.25 leaves NMS
    real work (as tests/test_torch_port_model.py)."""
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


@pytest.fixture(scope="module")
def jax_model():
    model, variables = jax_build_yolo11("n", nc=NC, imgsz=IMGSZ, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    return model, {c: _perturb(variables[c], rng) for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def handle(jax_model):
    yolo = YOLO("yolo11n", nc=NC, imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    yolo._ensure_built().load_state_dict(state_dict_from_jax(jax_model[1]), strict=True)
    return yolo


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (48 + 4 * i, 64, 3), np.uint8) for i in range(8)]


def _same_detections(got, want):
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.classes, w.classes)


def test_bucket_program_matches_the_jax_engine(jax_model, handle, images):
    # one bucket-4 batch through the JAX Engine's jitted program and through
    # the port Engine's bucket program (eager infer on the CPU); f32, the
    # convolutions summed in other orders: boxes to 1e-3 px, scores to 1e-4
    canvases = np.stack([letterbox_numpy(im, IMGSZ)[0] for im in images[:4]])
    jhandle = JaxYOLO("yolo11n", nc=NC, imgsz=IMGSZ)
    jhandle._model, jhandle._variables = jax_model
    jeng = JaxEngine(jhandle, max_batch=4, conf=CONF, iou=IOU)
    jeng._build()
    want = [np.asarray(t) for t in jeng._infer(jnp.asarray(canvases), jnp.float32(CONF),
                                               jnp.float32(IOU))]
    prog = Engine(handle, max_batch=4, conf=CONF, iou=IOU).program(4)
    prog.images.copy_(torch.from_numpy(canvases))
    prog.replay()
    got = [t.numpy() for t in prog.outputs]
    assert want[3].sum() > 20  # NMS had real work
    np.testing.assert_array_equal(got[3], want[3])
    for i, n in enumerate(want[3]):
        np.testing.assert_array_equal(got[2][i, :n], want[2][i, :n])
        np.testing.assert_allclose(got[0][i, :n], want[0][i, :n], atol=1e-3)
        np.testing.assert_allclose(got[1][i, :n], want[1][i, :n], atol=1e-4)


def test_engine_futures_equal_predict(handle, images):
    # a burst of 8 under a 2 s deadline forms one bucket-8 batch, the batch
    # predict(batch_size=8) runs: the same detections, bit for bit
    want = handle.predict(images, conf=CONF, iou=IOU, batch_size=8)
    eng = Engine(handle, max_batch=8, max_wait_ms=2000.0, conf=CONF, iou=IOU)
    with eng:
        futs = [eng.submit(im) for im in images]
        got = [f.result(timeout=120) for f in futs]
    assert eng.stats()["batches"] == 1 and eng.stats()["avg_batch"] == 8.0
    _same_detections(got, want)


def test_serve_stats_snapshot_equals_jax():
    rng = np.random.default_rng(3)
    ours, theirs = ServeStats(), JaxServeStats()
    for _ in range(3000):  # past the 2048-entry windows
        size = int(rng.integers(1, 33))
        lat = rng.uniform(1, 50, size).tolist()
        for s in (ours, theirs):
            s.requests += size
            s.completed += size - (size == 7)
            s.errors += size == 7
            s.batches += 1
            s.padded_slots += 32 - size
            s.batch_sizes.append(size)
            s.latencies_ms.extend(lat)
    assert ServeStats().snapshot() == JaxServeStats().snapshot()
    assert ours.snapshot() == theirs.snapshot()
    assert set(ours.snapshot()) >= {"p50_ms", "p95_ms", "avg_batch", "pad_fraction"}


@pytest.mark.parametrize("max_batch", [32, 48])
def test_bucket_equals_jax(max_batch):
    ours, theirs = types.SimpleNamespace(max_batch=max_batch), types.SimpleNamespace(
        max_batch=max_batch)
    assert ([Engine._bucket(ours, n) for n in range(1, 71)]
            == [JaxEngine._bucket(theirs, n) for n in range(1, 71)])
    assert sorted({Engine._bucket(ours, n) for n in range(1, 71)}) == Engine.buckets(ours)


def test_warmup_is_idempotent_before_and_after_start(handle, images):
    eng = Engine(handle, max_batch=4, conf=CONF)
    eng.warmup()
    programs = dict(eng._programs)
    assert sorted(programs) == [1, 2, 4]
    with eng:
        assert eng.submit(images[0]).result(timeout=120) is not None
        eng.warmup([2])
        eng.warmup()
    assert {b: id(p) for b, p in eng._programs.items()} == {b: id(p) for b, p in programs.items()}
    s = eng.stats()
    assert s["completed"] == 1 and s["errors"] == 0


@pytest.mark.parametrize("image,kwargs,match", [
    (np.zeros((64, 64), np.uint8), {}, "RGB"),
    (np.zeros((64, 64, 3), np.uint8), {"conf": 0.5}, "conf/iou"),
    (np.zeros((64, 64, 3), np.uint8), {"iou": 0.5}, "conf/iou"),
])
def test_submit_refuses_bad_input_and_per_request_thresholds(handle, image, kwargs, match):
    with pytest.raises(ValueError, match=match):
        Engine(handle, max_batch=2).submit(image, **kwargs)


def test_shutdown_fails_queued_requests(handle):
    eng = Engine(handle, max_batch=2)
    fut = eng.submit(np.zeros((48, 64, 3), np.uint8))  # never started
    eng.shutdown()
    with pytest.raises(RuntimeError, match="engine shut down"):
        fut.result(timeout=10)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(np.zeros((48, 64, 3), np.uint8))


def test_http_frontend(handle, images, tmp_path):
    eng = Engine(handle, max_batch=4, max_wait_ms=5.0, conf=CONF, iou=IOU)
    server = serve_http(eng, host="127.0.0.1", port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        write_png(tmp_path / "im.png", images[3])
        req = urllib.request.Request(f"{url}/predict", method="POST",
                                     data=(tmp_path / "im.png").read_bytes())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        det = eng.submit(images[3]).result(timeout=120)
        assert out == {"boxes": np.asarray(det.boxes, np.float64).round(2).tolist(),
                       "scores": np.asarray(det.scores, np.float64).round(4).tolist(),
                       "classes": det.classes.tolist(),
                       "names": [handle.names[c] for c in det.classes], "num": len(det)}
        assert out["num"] > 0
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            assert json.loads(r.read())["completed"] == 2
        bad = urllib.request.Request(f"{url}/predict", data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 415
        assert "cannot decode" in json.loads(err.value.read())["error"]
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_decode_without_cv2_or_pil_reads_png_and_names_the_missing(images, tmp_path,
                                                                   monkeypatch):
    write_png(tmp_path / "im.png", images[1])
    raw = (tmp_path / "im.png").read_bytes()
    np.testing.assert_array_equal(decode_image(raw), images[1])  # cv2 or PIL here
    monkeypatch.setitem(sys.modules, "cv2", None)  # import raises ImportError
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(decode_image(raw), images[1])  # ops/png.py
    with pytest.raises(UndecodableImage, match="cv2 is not installed.*PIL is not installed"):
        decode_image(b"\xff\xd8\xff\xe0 a JPEG header")
    with pytest.raises(UndecodableImage, match="PNG reader cannot decode"):
        decode_image(raw[:40])  # a truncated PNG
    with pytest.raises(UndecodableImage, match="empty"):
        decode_image(b"")


def test_a_failed_program_raises_from_warmup_and_fails_its_batch(handle, images,
                                                                monkeypatch):
    # on the card a failed capture; here the eager program's failure, which
    # takes the same paths: warmup() raises, served traffic fails its
    # futures and counts them, and the engine keeps serving other buckets
    eng = Engine(handle, max_batch=4, max_wait_ms=2000.0, conf=CONF)
    eng.warmup([1])
    net = eng._net

    def failing_net(x):
        if len(x) > 1:
            raise RuntimeError("capture failed")
        return net(x)

    monkeypatch.setattr(eng, "_net", failing_net)
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.warmup([2])
    with eng:
        futs = [eng.submit(im) for im in images[:3]]
        for f in futs:
            with pytest.raises(RuntimeError, match="capture failed"):
                f.result(timeout=120)
        assert eng.submit(images[0]).result(timeout=120) is not None  # bucket 1 serves
    s = eng.stats()
    assert s["errors"] == 3 and s["completed"] == 1 and sorted(eng._programs) == [1]


def test_export_round_trip_equals_the_source(handle, images, tmp_path):
    out = handle.export(tmp_path / "bundle")
    meta = json.loads((out / "meta.json").read_text())
    assert meta == {"family": "yolo11", "scale": "n", "nc": NC, "names": handle.names,
                    "imgsz": IMGSZ, "fused": True, "int8": False}
    loaded = YOLO.from_export(out, device="cpu")
    assert loaded.dtype == handle.dtype == torch.float32
    fused, refused = handle._fused_model().state_dict(), loaded._fused_model().state_dict()
    assert all(torch.equal(fused[k], refused[k]) for k in fused)  # the fold again: same bits
    _same_detections(loaded.predict(images, conf=CONF, iou=IOU, batch_size=8),
                     handle.predict(images, conf=CONF, iou=IOU, batch_size=8))


def test_exported_weights_equal_jax_fuse_conv_bn(jax_model, handle, tmp_path):
    handle.export(tmp_path / "bundle")
    got = torch.load(tmp_path / "bundle" / "variables.pt", weights_only=True)
    fused = jax.tree_util.tree_map(np.asarray, jax_fuse_conv_bn(jax_model[1]))
    want = state_dict_from_jax(fused)
    assert sorted(got) == sorted(want)
    # 1e-6 of each tensor's largest entry: the folded bias b - m * s cancels,
    # and XLA contracts it into one rounding where PyTorch rounds twice, so a
    # small bias lands an ulp of its operands (1.5e-8) away
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item(), err_msg=k)


def test_from_export_refuses_int8_and_jax_bundles(handle, tmp_path):
    """An int8 bundle without its qtree (``quant.pt``, which int8 bundles
    carry since int8 serving is ported) and a JAX bundle are refused."""
    out = handle.export(tmp_path / "bundle")
    meta = json.loads((out / "meta.json").read_text())
    (out / "meta.json").write_text(json.dumps({**meta, "int8": True}))
    with pytest.raises(FileNotFoundError, match="quant.pt"):
        YOLO.from_export(out, device="cpu")
    (out / "meta.json").write_text(json.dumps(meta))
    (out / "variables.pt").unlink()  # as a JAX bundle: an orbax variables/ directory
    with pytest.raises(NotImplementedError, match="needs jax"):
        YOLO.from_export(out, device="cpu")


def _write_dataset(root, n_val=6):
    """Grey noise images with one to three red or green boxes, as PNG."""
    import yaml

    rng = np.random.default_rng(11)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n_val):
            img = rng.integers(0, 256, (IMGSZ, IMGSZ, 1)).repeat(3, -1).astype(np.uint8)
            lines = []
            for _ in range(int(rng.integers(1, 4))):
                w, h = (int(v) for v in rng.integers(10, 24, 2))
                x, y = (int(v) for v in rng.integers(0, IMGSZ - 24, 2))
                c = int(rng.integers(0, 2))
                img[y:y + h, x:x + w] = (255, 0, 0) if c == 0 else (0, 255, 0)
                lines.append(f"{c} {(x + w / 2) / IMGSZ:.6f} {(y + h / 2) / IMGSZ:.6f} "
                             f"{w / IMGSZ:.6f} {h / IMGSZ:.6f}")
            write_png(root / "images" / split / f"{i}.png", img)
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines))
    (root / "data.yaml").write_text(yaml.dump({"path": str(root), "train": "images/train",
                                               "val": "images/val",
                                               "names": {0: "red", 1: "green", 2: "blue"}}))
    return root / "data.yaml"


def test_val_equals_trainer_validate(handle, tmp_path):
    data = str(_write_dataset(tmp_path / "ds"))
    kw = dict(imgsz=IMGSZ, batch=4, amp=False, conf=0.001, project=str(tmp_path / "runs"))
    got = handle.val(data, name="val", **kw)
    trainer = Trainer(make_config("yolo11n", data, device="cpu", name="direct", **kw),
                      init_state_dict=handle._model.state_dict())
    want, _ = trainer.validate()
    assert {"map50", "map", "curves"} <= set(got)
    got, want = (jax.tree_util.tree_leaves_with_path(m) for m in (got, want))
    assert [path for path, _ in got] == [path for path, _ in want]
    for (path, g), (_, w) in zip(got, want):  # every metric and curve, bit for bit
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    with pytest.raises(ValueError, match="quantize_int8"):  # the JAX package's error
        handle.val(data, int8=True)


def test_engine_serves_its_weights_after_the_handle_trains(handle, images, tmp_path):
    # the Engine pins the folded weights it was made with (on the card its
    # graphs read them by address): a train() of the handle afterwards
    # changes what the handle predicts, not what the Engine serves
    yolo = YOLO("yolo11n", nc=NC, imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    yolo._ensure_built().load_state_dict(handle._model.state_dict(), strict=True)
    yolo._weights_loaded = True
    canvases = torch.from_numpy(np.stack([letterbox_numpy(im, IMGSZ)[0] for im in images]))
    eng = Engine(yolo, max_batch=8, max_wait_ms=2000.0, conf=CONF, iou=IOU)
    eng.warmup([8])

    def serve_burst():
        with eng:
            futs = [eng.submit(im) for im in images]
            return [f.result(timeout=120) for f in futs]

    before, infer_before = serve_burst(), yolo.infer(canvases, CONF, IOU)
    yolo.train(str(_write_dataset(tmp_path / "ds")), epochs=1, imgsz=IMGSZ, batch=4,
               amp=False, mosaic=0.0, workers=0, project=str(tmp_path / "runs"), name="t")
    infer_after = yolo.infer(canvases, CONF, IOU)
    assert not torch.equal(infer_after[1], infer_before[1])  # the handle's weights moved
    _same_detections(serve_burst(), before)
    assert eng.stats()["batches"] == 2 and eng.stats()["errors"] == 0


@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "nearest"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_letterbox_batch_matches_jax(dtype, bilinear):
    # scales below and above 1; a pad that puts the image off the canvas's
    # left edge and one past its bottom, so border pixels are sampled
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (4, 40, 56, 3))
    images = images.astype(np.uint8) if dtype == np.uint8 else images.astype(np.float32)
    scales = np.array([0.7, 1.0, 1.6, 1.13], np.float32)
    pads = np.array([[5, 7], [0, 12], [-9, 3], [4, 30]], np.float32)
    want = np.asarray(jax_letterbox_batch(jnp.asarray(images), jnp.asarray(scales),
                                          jnp.asarray(pads), 64, 114.0, bilinear))
    got = letterbox_batch(torch.from_numpy(images), torch.from_numpy(scales),
                          torch.from_numpy(pads), 64, 114.0, bilinear)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 64, 3)
    assert (want == 114.0).any() and (want != 114.0).mean() > 0.4  # fill and content
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

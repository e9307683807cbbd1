"""The port's ultralytics .pt reader (``models/torch_import.py``) against the
JAX package's on the CPU: the same written .pt files read to the same keys
and bit-identical arrays (a plain state dict, a stub-class module tree, the
EMA wrapper, a fused conv-bias checkpoint, fp16); ``import_state_dict``'s
report and weights, strict and not, against JAX's on JAX trees made by
``jax.eval_shape`` plus numpy values (no compile); ``from_ultralytics``
predicting what the JAX package predicts from the same file; the Trainer
fine-tuning from an ultralytics .pt; ``YOLO.load``."""

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deal_yolo_daya_tpu.api import YOLO as JaxYOLO
from deal_yolo_daya_tpu.models import build_yolo11 as jax_build_yolo11
from deal_yolo_daya_tpu.models.registry import make_detector as jax_make_detector
from deal_yolo_daya_tpu.models.torch_import import export_state_dict as jax_export_state_dict
from deal_yolo_daya_tpu.models.torch_import import import_state_dict as jax_import_state_dict
from deal_yolo_daya_tpu.models.torch_import import read_torch_checkpoint as jax_read
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import fuse_conv_bn, make_detector, state_dict_from_jax
from deal_yolo_daya_tpu_torch.models.torch_import import (detect_nc, export_state_dict,
                                                          import_state_dict, read_torch_checkpoint)
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.test_data import make_dataset
from tests.test_torch_port_model import _perturb

REPO = Path(__file__).resolve().parents[1]
IMGSZ = 64


def _tool():
    spec = importlib.util.spec_from_file_location("ultralytics_pt",
                                                  REPO / "tools" / "ultralytics_pt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ULTRALYTICS_PT = _tool()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _shapes(family, scale, nc):
    model = jax_make_detector(family, scale, nc)
    return model, jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False),
        jax.random.PRNGKey(0))


def _tree(family, scale, nc, seed):
    """A JAX variables tree with numpy-made values (BN variances positive)."""
    model, shapes = _shapes(family, scale, nc)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "kernel":
            return rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape).astype(np.float32)
        return rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, {c: tree[c] for c in ("params", "batch_stats")}


# ---------------------------------------------------------------- the reader

def _write(kind, path):
    """A .pt of each kind the reader must take, from a yolo11n nc 3 model."""
    model = make_detector("yolo11", "n", 3)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    sd = model.state_dict()
    names = {0: "cat", 1: "狗", 2: "car"}
    if kind == "state_dict":  # a plain state dict with the DetectionModel prefix
        torch.save({f"model.{k}": v for k, v in sd.items()}, path)
    elif kind == "module_tree":
        ULTRALYTICS_PT.write_checkpoint(path, sd, names, dtype=torch.float32)
    elif kind == "ema_wrapper":
        ULTRALYTICS_PT.write_checkpoint(path, sd, names, dtype=torch.float32, wrap_ema=True)
    elif kind == "fused":  # conv bias, no bn
        ULTRALYTICS_PT.write_checkpoint(path, fuse_conv_bn(model).state_dict(), names,
                                        dtype=torch.float32)
    elif kind == "fp16":  # ultralytics saves half precision, with its BN counters
        sd = {**sd, "0.bn.num_batches_tracked": torch.tensor(7)}
        ULTRALYTICS_PT.write_checkpoint(path, sd, names, dtype=torch.float16)
    return path


@pytest.mark.parametrize("kind", ["state_dict", "module_tree", "ema_wrapper", "fused", "fp16"])
def test_reader_equals_jax(kind, tmp_path):
    path = _write(kind, tmp_path / f"{kind}.pt")
    assert "ultralytics" not in sys.modules  # the stand-ins are nowhere to import
    got, got_meta = read_torch_checkpoint(path)
    want, want_meta = jax_read(path)
    assert list(got) == list(want) and len(got) > 150
    for key, arr in want.items():  # bit-identical f32
        assert got[key].dtype == torch.float32 and arr.dtype == np.float32
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert got_meta == want_meta
    if kind != "state_dict":
        assert got_meta["names"] == {0: "cat", 1: "狗", 2: "car"}
    assert detect_nc(got) == 3


def test_reader_refuses_a_file_without_weights(tmp_path):
    torch.save({"model": {}}, tmp_path / "empty.pt")
    with pytest.raises(ValueError, match="could not locate module weights"):
        read_torch_checkpoint(tmp_path / "empty.pt")
    with pytest.raises(ValueError, match="could not locate module weights"):
        jax_read(tmp_path / "empty.pt")


# ---------------------------------------------------------------- the import

# (family, nc of the checkpoint, nc of the target, strict, how the checkpoint is edited)
IMPORTS = [("yolo11", 3, 3, True, "extras"), ("yolo11", 3, 5, False, "drop"),
           ("yolov8", 2, 2, True, "fused"), ("yolo12", 4, 2, False, "extras")]


@pytest.mark.parametrize("family,nc_ckpt,nc,strict,edit", IMPORTS)
def test_import_state_dict_equals_jax(family, nc_ckpt, nc, strict, edit):
    """The report (every field) and the imported weights: the same as JAX's,
    bit for bit, under ``strict`` and under the intersect load (a class head
    of another nc keeps the target's values, a dropped key is missing)."""
    _, source = _tree(family, "n", nc_ckpt, seed=1)
    _, target = _tree(family, "n", nc, seed=2)
    sd = {f"model.{k}": v for k, v in jax_export_state_dict(source).items()}
    if edit == "extras":
        sd["model.0.bn.num_batches_tracked"] = np.float32(3)
        detect = {"yolo11": 23, "yolov8": 22, "yolo12": 21}[family]
        sd[f"model.{detect}.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(
            1, 16, 1, 1)
        sd["model.99.head.weight"] = np.zeros(4, np.float32)  # unused
        sd["names"] = np.zeros(1, np.float32)                 # dropped
    elif edit == "drop":
        del sd["model.2.cv1.conv.weight"]
    elif edit == "fused":
        for k in ("weight", "bias", "running_mean", "running_var"):
            del sd[f"model.1.bn.{k}"]
        sd["model.1.conv.bias"] = np.linspace(-1, 1, 32, dtype=np.float32)
    want_vars, want = jax_import_state_dict(sd, target, strict=strict)
    model = make_detector(family, "n", nc)
    model.load_state_dict(state_dict_from_jax(target), strict=True)
    got_sd, got = import_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                                    model, strict=strict)
    for field in ("unused", "skipped", "fused", "dropped", "imported"):
        assert got[field] == want[field], field
    for field in ("missing", "shape_mismatch"):  # JAX lists them in its tree's order
        assert sorted(got[field]) == sorted(want[field]), field
    if nc != nc_ckpt:  # the class head's logit convs, and nothing else
        detect = {"yolo11": 23, "yolov8": 22, "yolo12": 21}[family]
        assert set(got["shape_mismatch"]) == {f"{detect}.cv3.{i}.2.{p}" for i in range(3)
                                              for p in ("weight", "bias")}
    want_sd = state_dict_from_jax(want_vars)
    assert sorted(got_sd) == sorted(want_sd)
    for key, w in want_sd.items():
        assert torch.equal(got_sd[key], w), key


def test_import_strict_raises_as_jax():
    _, source = _tree("yolo11", "n", 3, seed=1)
    sd = jax_export_state_dict(source)
    model = make_detector("yolo11", "n", 3)
    bad = {**sd, "0.conv.weight": np.zeros((16, 3, 5, 5), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        import_state_dict(bad, model)
    missing = {k: v for k, v in sd.items() if k != "10.cv1.conv.weight"}
    with pytest.raises(ValueError, match="missing 1 expected keys"):
        import_state_dict(missing, model)
    assert sorted(export_state_dict(model)) == sorted(sd)


# ---------------------------------------------------------------- the API

@pytest.fixture(scope="module")
def ultralytics_file(tmp_path_factory):
    """An ultralytics-layout fp16 best.pt of a yolo11n at nc 80 with the
    perturbed weights of tests/test_torch_port_model.py (conf 0.25 leaves
    NMS real work), and those weights as the fp16-rounded JAX tree."""
    _, variables = jax_build_yolo11("n", nc=80, imgsz=IMGSZ, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    variables = {c: _perturb(variables[c], rng) for c in ("params", "batch_stats")}
    sd = {k: torch.from_numpy(v) for k, v in jax_export_state_dict(variables).items()}
    path = tmp_path_factory.mktemp("ult") / "best.pt"
    ULTRALYTICS_PT.write_checkpoint(path, sd, {i: f"n{i}" for i in range(80)},
                                    dtype=torch.float16)
    return path


def test_from_ultralytics_predicts_what_jax_predicts(ultralytics_file):
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(64, 64), (48, 80), (90, 50)]]
    jyolo = JaxYOLO.from_ultralytics(ultralytics_file, imgsz=IMGSZ)
    # the JAX handle computes in bf16: the same imported variables in f32
    jyolo._model = jax_build_yolo11("n", nc=80, imgsz=IMGSZ, dtype=jnp.float32)[0]
    jyolo._infer_jit = None
    want = jyolo.predict(images, conf=0.25, iou=0.7, batch_size=4)
    yolo = YOLO.from_ultralytics(ultralytics_file, imgsz=IMGSZ, device="cpu",
                                 dtype=torch.float32)
    assert (yolo.family, yolo.scale, yolo.nc) == ("yolo11", "n", 80)
    assert yolo.names == jyolo.names == [f"n{i}" for i in range(80)]
    for field in ("missing", "unused", "fused", "shape_mismatch", "imported"):
        assert yolo.import_report[field] == jyolo.import_report[field] or \
            sorted(yolo.import_report[field]) == sorted(jyolo.import_report[field]), field
    got = yolo.predict(images, conf=0.25, iou=0.7, batch_size=4)
    assert sum(len(d) for d in want) > 20  # NMS had real work
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.classes, w.classes)
        # tests/test_torch_port_model.py's tolerances (the letterbox resize
        # differs by a u8 level at some pixels between torch and cv2)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=0.01)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-4)
    # YOLO("<ultralytics>.pt") is the same handle
    again = YOLO(str(ultralytics_file), imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    for k, v in yolo._model.state_dict().items():
        assert torch.equal(again._model.state_dict()[k], v), k


def test_trainer_fine_tunes_from_an_ultralytics_pt(ultralytics_file, tmp_path):
    """model=<ultralytics .pt> under another nc: the intersect load keeps the
    class head's fresh init and reports its keys; every other tensor comes
    from the checkpoint (fp16-rounded); a second spec's explicit weights
    win; a .pt without detection weights raises the JAX ValueError."""
    data_yaml = make_dataset(tmp_path, n_train=4, n_val=2, imgsz=64, nc=2)
    cfg = dict(data=str(data_yaml), epochs=1, imgsz=64, batch=4, amp=False, close_mosaic=0,
               project=str(tmp_path / "runs"), seed=0, max_boxes=16, device="cpu", workers=1)
    t = Trainer(TrainConfig(model=str(ultralytics_file), name="ft", **cfg))
    assert (t.family, t.scale, t.nc) == ("yolo11", "n", 2)
    sd, _ = read_torch_checkpoint(ultralytics_file)
    start = t.state.model.state_dict()
    # nc 80 -> 2 narrows the class branch (c3 = max(64, min(nc, 100))) and its logits
    head = {k for k, v in start.items() if v.shape != sd[f"model.{k}"].shape}
    assert set(t.import_report["shape_mismatch"]) == head
    assert head and all(k.startswith("23.cv3.") for k in head)
    assert {f"23.cv3.{i}.2.{p}" for i in range(3) for p in ("weight", "bias")} <= head
    for k, v in start.items():
        if k not in head:
            assert torch.equal(v, sd[f"model.{k}"]), k
    fresh = Trainer(TrainConfig(model="yolo11n", name="fresh", **cfg)).state.model.state_dict()
    for k in head:  # the fresh init at the same seed
        assert torch.equal(start[k], fresh[k]), k
    t.train()
    explicit = Trainer(TrainConfig(model=str(ultralytics_file), name="ex", **cfg),
                       init_state_dict=fresh)
    assert explicit.import_report["imported"] == len(fresh)  # the given weights, all of them
    assert not explicit.import_report["shape_mismatch"]
    assert torch.equal(explicit.state.model.state_dict()["0.conv.weight"], fresh["0.conv.weight"])
    torch.save({"model": {}}, tmp_path / "empty.pt")
    with pytest.raises(ValueError, match="could not locate module weights"):
        Trainer(TrainConfig(model=str(tmp_path / "empty.pt"), name="bad", **cfg))
    torch.save({"model.5.weight": torch.zeros(3)}, tmp_path / "nodetect.pt")
    with pytest.raises(ValueError, match="not a YOLO11/YOLOv8/YOLOv12 detection state dict"):
        Trainer(TrainConfig(model=str(tmp_path / "nodetect.pt"), name="bad2", **cfg))


def test_load_puts_a_trainer_checkpoint_into_a_handle(tmp_path):
    data_yaml = make_dataset(tmp_path, n_train=4, n_val=2, imgsz=64, nc=2)
    t = Trainer(TrainConfig(model="yolov8n", data=str(data_yaml), epochs=1, imgsz=64, batch=4,
                            amp=False, close_mosaic=0, project=str(tmp_path / "runs"), name="l",
                            max_boxes=16, device="cpu", workers=1))
    t.train()
    best = Path(t.run.path) / "weights" / "best.pt"
    yolo = YOLO("yolo11s", nc=80, imgsz=96, device="cpu").load(best)
    assert (yolo.family, yolo.scale, yolo.nc, yolo.imgsz) == ("yolov8", "n", 2, 96)
    assert yolo.names == list(t.names)
    want = YOLO(str(best), device="cpu")._model.state_dict()
    for k, v in yolo._model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="from_ultralytics"):
        yolo.load(_write("module_tree", tmp_path / "u.pt"))

"""The port's Trainer on the CPU: one epoch against the JAX Trainer on the
same dataset and weights, then the port alone (the API, options, foreign
checkpoints; accumulation is in tests/test_torch_port_trainer_nbs.py, and
single_cls, freeze, resume and checkpoint pruning in
tests/test_torch_port_trainer_runs.py).

Against JAX: yolo11n at 128 px, batch 4, f32, on-card augmentation with
every random transform neutralised (mosaic, scale, translate, HSV and flips
0), so both augmentations reduce to the same HSV round trip; 8 train images
(2 steps) and 4 val images written as PNG at 128 px, so that neither
package resizes. The JAX side runs flax's two-pass batch variance for the
reasons stated in tests/test_torch_port_train.py, and so do its
tolerances: loss means within 5e-4 relative (under jit XLA keeps f32 across
the assigner's bf16 metric, which moves a few target scores by a bf16 step
and the train cls loss by ~2e-4 here; and the 5 decimals of results.csv),
EMA moves within 5e-2 of each tensor's largest move (the same target
scores move a few head gradients by ~2%, as there)."""

import copy
import csv
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.train import trainer as port_trainer
from deal_yolo_daya_tpu_torch.train.trainer import (TrainConfig, Trainer, inference_state_dict,
                                                    load_checkpoint, train_run)
from deal_yolo_daya_tpu_torch.models import make_detector
from tests.test_data import make_dataset
from tests.test_torch_port_torch_import import ULTRALYTICS_PT

IMGSZ, NC, BATCH = 128, 2, 4
LR0 = 1e-3
NEUTRAL = dict(mosaic=0.0, scale=0.0, translate=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
               fliplr=0.0, flipud=0.0)
LOSS_RTOL = 5e-4
CSV_ATOL = 1.5e-5   # results.csv keeps 5 decimals
DELTA_RTOL = 5e-2
METRIC_ATOL = 1e-6


def _write_dataset(root: Path, n_train=8, n_val=4, seed=5):
    """Grey noise images at IMGSZ with one to three 14-18 px boxes, pure red
    or green by class, each in its own quadrant and centred a pixel off a
    stride-8 anchor: the start weights' 16 px boxes overlap them, no two
    anchors lie at the same distance from a centre, no GT has more candidate
    anchors than the assigner's top-k and no anchor lies in two GTs (the
    assignment then does not hang on near-ties of its bf16 metric). Grey and
    pure colours go through the HSV round trip of unit gains exactly; other
    colours land a level low in about a quarter of the pixels under XLA's
    jit (which rewrites the arithmetic) but not eagerly nor in the port.
    PNG via cv2."""
    import cv2
    import yaml

    rng = np.random.default_rng(seed)
    half = IMGSZ // 2
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, (IMGSZ, IMGSZ, 1)).repeat(3, -1).astype(np.uint8)
            lines = []
            for q in rng.permutation(4)[:int(rng.integers(1, 4))]:
                w, h = (2 * int(v) for v in rng.integers(7, 10, 2))
                x = half * (q % 2) + 8 * int(rng.integers(2, 6)) + 5 - w // 2
                y = half * (q // 2) + 8 * int(rng.integers(2, 6)) + 5 - h // 2
                c = int(rng.integers(0, NC))
                img[y:y + h, x:x + w] = (255, 0, 0) if c == 0 else (0, 255, 0)
                lines.append(f"{c} {(x + w / 2) / IMGSZ:.6f} {(y + h / 2) / IMGSZ:.6f} "
                             f"{w / IMGSZ:.6f} {h / IMGSZ:.6f}")
            cv2.imwrite(str(root / "images" / split / f"{i}.png"), img[..., ::-1])
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines))
    data_yaml = root / "data.yaml"
    data_yaml.write_text(yaml.dump({"path": str(root), "train": "images/train",
                                    "val": "images/val", "names": {0: "red", 1: "green"}}))
    return data_yaml


def _start_weights(variables):
    """Box-head biases favouring DFL bin 1: boxes ~20 px, overlapping the
    small GTs (the class biases keep their prior, so that no two anchors'
    align metrics tie)."""
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        bias = np.zeros((4, 16), np.float32)
        bias[:, 1] = 6.0
        params["detect"][f"box{i}_2"]["bias"] = bias.reshape(-1)
    return {"params": params,
            "batch_stats": jax.tree_util.tree_map(np.array, variables["batch_stats"])}


def _config(cls, data_yaml, project, name, **kw):
    """conf 1e-6 and max_det 1000: at the class prior every anchor's score
    (~4e-4 and up) passes and every anchor's box is kept (336 anchors and 2
    classes at 128 px), so that validation has boxes to match."""
    return cls(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=IMGSZ, batch=BATCH,
               amp=False, close_mosaic=0, project=str(project), name=name, seed=0,
               max_boxes=16, lr0=LR0, warmup_epochs=0, workers=1, device_augment=True,
               conf=1e-6, max_det=1000, **{**NEUTRAL, **kw})


def _rows(save_dir):
    with open(Path(save_dir) / "results.csv", newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of the JAX Trainer and of the port's, from the same
    weights. Built once: the JAX compiles are the slow part."""
    from flax.linen import normalization
    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("port_trainer")
    data_yaml = _write_dataset(tmp / "ds")
    probe = JaxTrainer(_config(JaxTrainConfig, data_yaml, tmp / "jax", "probe", device="1",
                               steps_per_dispatch=1, val=False))
    start = _start_weights({"params": probe.state.params,
                            "batch_stats": probe.state.batch_stats})
    jt = JaxTrainer(_config(JaxTrainConfig, data_yaml, tmp / "jax", "run", device="1",
                            steps_per_dispatch=1), init_variables=start)
    assert jt.cfg.cache == "device" and len(jt.train_loader) == 2

    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass_stats  # while the programs are traced
    try:
        jres = jt.train()
    finally:
        normalization._compute_stats = compute_stats
    jax_record = {"rows": _rows(jres["save_dir"]), "metrics": jres["metrics"],
                  "ema": state_dict_from_jax({"params": jax.device_get(jt.state.ema_params)}),
                  "initial": state_dict_from_jax(start)}

    pt = Trainer(_config(TrainConfig, data_yaml, tmp / "port", "run", device="cpu"),
                 init_state_dict=state_dict_from_jax(start))
    pres = pt.train()
    return {"jax": jax_record, "port": pt, "port_result": pres, "data_yaml": data_yaml,
            "tmp": tmp}


def test_results_csv_row_matches_jax(runs):
    (want,), (got,) = runs["jax"]["rows"], _rows(runs["port_result"]["save_dir"])
    assert list(got) == list(want)  # the 15 columns, in order
    assert got["epoch"] == want["epoch"] == "1"
    for col in want:
        if col in ("epoch", "time"):
            continue
        w, g = float(want[col]), float(got[col])
        assert g == pytest.approx(w, rel=LOSS_RTOL, abs=CSV_ATOL), col
    assert float(got["train/cls_loss"]) > 0 and float(got["val/cls_loss"]) > 0


def test_validate_metrics_match_jax(runs):
    want, got = runs["jax"]["metrics"], runs["port_result"]["metrics"]
    for k in ("precision", "recall", "map50", "map"):
        assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k
    assert got["recall"] > 0  # some boxes matched: the comparison is not of zeros
    np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"], atol=METRIC_ATOL)


def test_ema_matches_jax(runs):
    """The EMA's move from the start weights, per tensor."""
    init, want = runs["jax"]["initial"], runs["jax"]["ema"]
    got = runs["port"].state.ema_state_dict()
    assert sorted(got) == sorted(want)
    eps = 4 * np.finfo(np.float32).eps
    for name, g in got.items():
        w = (want[name] - init[name]).numpy()
        d = (g - init[name]).numpy()
        floor = eps * float(np.abs(init[name].numpy()).max()) + 1e-9
        assert np.abs(d - w).max() <= DELTA_RTOL * np.abs(w).max() + floor, name


def test_artifacts_and_checkpoints(runs):
    save_dir = Path(runs["port_result"]["save_dir"])
    args = (save_dir / "args.yaml").read_text()
    assert "imgsz: 128" in args and "device_augment: true" in args
    for tag in ("last", "best"):
        ckpt = load_checkpoint(save_dir / "weights" / f"{tag}.pt")
        assert ckpt["epoch"] == 0 and ckpt["nc"] == NC and ckpt["names"] == ["red", "green"]
        live = runs["port"].state.state()
        for k, v in live["model"].items():
            assert torch.equal(ckpt["model"][k], v), k
        for k, v in live["ema"].items():
            assert torch.equal(ckpt["ema"][k], v), k
        assert ckpt["updates"] == 2


def test_yolo_from_best_predicts_what_validation_saw(runs):
    """YOLO(best.pt) (BN folded, f32) on a val batch against the Trainer's
    own validation forward (unfused EMA, f32): the same detections, boxes
    within 1e-2 px and scores within 1e-4 (fused vs unfused f32). At the
    class prior many scores lie that close, so their order may swap: each
    detection is matched to one of the other side's of its class."""
    pt = runs["port"]
    yolo = YOLO(str(Path(runs["port_result"]["save_dir"]) / "weights" / "best.pt"),
                device="cpu")
    assert (yolo.nc, yolo.names, yolo.imgsz) == (NC, ["red", "green"], IMGSZ)
    batch = next(pt.val_loader.epoch(0))
    images = torch.from_numpy(batch.images)
    gt = [torch.from_numpy(a) for a in (batch.gt_boxes, batch.gt_classes, batch.gt_mask)]
    inv = torch.tensor([[m[2], m[3][0], m[3][1], m[1][1], m[1][0]] for m in batch.meta])
    (vb, vs, vc, vn), *_ = pt.eval_step(images, *gt, inv)
    yb, ys, yc, yn = yolo.infer(images, conf=pt.cfg.conf, iou=pt.cfg.iou, max_det=pt.cfg.max_det)
    assert torch.equal(yn, vn) and int(vn.min()) > 0
    for i, n in enumerate(vn.tolist()):
        box_err = (yb[i, :n, None] - vb[i, None, :n]).abs().amax(-1)      # (n, n)
        pair = ((box_err <= 1e-2) & ((ys[i, :n, None] - vs[i, None, :n]).abs() <= 1e-4)
                & (yc[i, :n, None] == vc[i, None, :n]))
        assert pair.any(1).all() and pair.any(0).all(), i


# ---------------------------------------------------------------- the port alone


def _small(tmp_path, name, data_yaml=None, **kw):
    """A port Trainer at 64 px on tests/test_data.py's dataset, f32, CPU."""
    data_yaml = data_yaml or make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    cfg = TrainConfig(**{**dict(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=64,
                                batch=4, amp=False, close_mosaic=0, project=str(tmp_path / "runs"),
                                name=name, seed=0, max_boxes=16, warmup_epochs=0.5,
                                device="cpu", workers=1), **kw})
    return Trainer(cfg)


def test_yolo_train_adopts_the_ema_weights(tmp_path):
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=3)
    yolo = YOLO("yolo11n", nc=80, imgsz=640, device="cpu")
    result = yolo.train(str(data_yaml), epochs=1, imgsz=64, batch=4, amp=False,
                        project=str(tmp_path / "runs"), name="api", max_boxes=16, workers=1,
                        close_mosaic=0, my_option=1)
    assert yolo.trainer.cfg.extra == {"my_option": 1}
    assert (yolo.nc, yolo.imgsz, yolo.names) == (3, 64, ["c0", "c1", "c2"])
    want = inference_state_dict(yolo.trainer.state.state())
    for k, v in yolo._model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert Path(result["save_dir"]) == yolo.save_dir
    assert len(yolo.predict(str(Path(data_yaml).parent / "images" / "val"), conf=0.001)) == 4
    # a second train() starts from these weights
    again = copy.deepcopy(yolo._model.state_dict())
    yolo.train(str(data_yaml), epochs=1, imgsz=64, batch=4, amp=False, lr0=0.0,
               warmup_epochs=0, project=str(tmp_path / "runs"), name="api", max_boxes=16,
               workers=1, close_mosaic=0)
    start = yolo.trainer.state.state()["model"]  # lr 0: parameters stay where they began
    for name, _ in yolo._model.named_parameters():
        assert torch.equal(start[name], again[name]), name


@pytest.mark.parametrize("option", [dict(device="1x2")])
def test_options_not_ported_raise(tmp_path, monkeypatch, option):
    """A model axis (tensor parallelism) over two visible (CPU) devices."""
    monkeypatch.setenv("DYD_CPU_DEVICES", "2")
    with pytest.raises(NotImplementedError, match="not ported"):
        _small(tmp_path, "x", **option)


def test_trainer_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    data_yaml = make_dataset(tmp_path, n_train=4, n_val=2, imgsz=64, nc=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(data=str(data_yaml), project=str(tmp_path / "runs")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_run("yolo11n", str(data_yaml), project=str(tmp_path / "runs"))


def test_foreign_checkpoint_is_refused(tmp_path):
    """A .pt that is no checkpoint of the port's Trainer goes through the
    ultralytics reader: one without detection weights raises the JAX
    ValueError, a valid ultralytics .pt (fp16, stand-in classes) loads."""
    path = tmp_path / "yolo11n.pt"
    torch.save({"model": {}}, path)
    with pytest.raises(ValueError, match="could not locate module weights"):
        YOLO(str(path), device="cpu")
    model = make_detector("yolov8", "n", 2)
    ULTRALYTICS_PT.write_checkpoint(tmp_path / "best.pt", model.state_dict(), {0: "a", 1: "b"})
    yolo = YOLO(str(tmp_path / "best.pt"), device="cpu")
    assert (yolo.family, yolo.scale, yolo.nc, yolo.names) == ("yolov8", "n", 2, ["a", "b"])
    for k, v in model.state_dict().items():
        assert torch.equal(yolo._model.state_dict()[k], v.half().float()), k


def test_config_has_the_jax_fields():
    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig

    want = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "extra"} == \
        {k: v for k, v in want.items() if k != "extra"}
    assert port_trainer.frozen_modules(24) == tuple(str(i) for i in range(23))

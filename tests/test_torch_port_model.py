"""The port's yolo11n against the JAX package: weight carry-over, parameter
count, raw head outputs, the BN fold and predict end to end, in f32 on the
CPU with the same weights and the same numpy-made inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deal_yolo_daya_tpu.api import YOLO as JaxYOLO
from deal_yolo_daya_tpu.models import build_yolo11 as jax_build_yolo11
from deal_yolo_daya_tpu.models.torch_import import export_state_dict
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import (
    YOLO11,
    build_yolo11,
    fuse_conv_bn,
    param_count,
    state_dict_from_jax,
)
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

IMGSZ = 64


def _perturb(tree, rng, path=()):
    """Random BN statistics and louder head outputs, so that random-init
    outputs are not degenerate; class biases 0 so that conf 0.25 leaves NMS
    real work."""
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
    model, variables = jax_build_yolo11("n", nc=80, imgsz=IMGSZ, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    variables = {c: _perturb(variables[c], rng) for c in ("params", "batch_stats")}
    return model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = YOLO11(nc=80, scale="n")
    model.load_state_dict(state_dict_from_jax(jax_model[1]), strict=True)
    return model.eval()


def _images(rng, n):
    return rng.uniform(0, 255, (n, IMGSZ, IMGSZ, 3)).astype(np.float32)


def test_carry_over_round_trip_equals_jax_export(jax_model, port_model):
    # JAX tree -> port state dict -> module -> state dict is exactly the
    # JAX package's own ultralytics-layout export
    want = export_state_dict(jax_model[1])
    got = port_model.state_dict()
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


def test_jax_export_loads_strict(jax_model):
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_state_dict(jax_model[1]).items()}
    model = YOLO11(nc=80, scale="n")
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # depthwise HWIO (3, 3, 1, C) -> OIHW (C, 1, 3, 3)
    dw = model.state_dict()["23.cv3.0.0.0.conv.weight"]
    k = np.asarray(jax_model[1]["params"]["detect"]["cls0_0dw"]["dw"]["conv"]["kernel"])
    assert k.shape[2] == 1 and dw.shape == (k.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(dw.numpy(), k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("scale,expected", [("n", 2_624_064), ("s", 9_458_736)])
def test_param_count(scale, expected):
    # ultralytics' count minus the 16 fixed DFL weights, as tests/test_model.py
    assert param_count(build_yolo11(scale, nc=80, device="cpu")) == expected


def test_raw_head_outputs_match_jax(jax_model, port_model):
    model, variables = jax_model
    x = _images(np.random.default_rng(2), 2) / 255.0
    jbox, jcls = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tbox, tcls = port_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for j, t in zip(jbox + jcls, tbox + tcls):
        j = np.asarray(j)
        assert j.std() > 0.5  # not degenerate
        # f32, different conv summation order: 1e-4 of the output scale
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), j,
                                   rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_fused_model_matches_unfused(port_model):
    # BN folded into the convs and 1/255 into the stem: raw 0..255 input
    x = torch.from_numpy(_images(np.random.default_rng(3), 2)).permute(0, 3, 1, 2)
    fused = fuse_conv_bn(port_model, input_scale=1.0 / 255.0)
    assert not any(type(m).__name__ == "BatchNorm" for m in fused.modules())
    with torch.no_grad():
        want = port_model(x / 255.0)
        got = fused(x)
    for w, g in zip(want[0] + want[1], got[0] + got[1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


def test_predict_matches_jax(jax_model):
    model, variables = jax_model
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(64, 64), (48, 80), (90, 50)]]
    jyolo = JaxYOLO("yolo11n", nc=80, imgsz=IMGSZ)
    jyolo._model, jyolo._variables = model, variables
    want = jyolo.predict(images, conf=0.25, iou=0.7, batch_size=4)

    yolo = YOLO("yolo11n", nc=80, imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    yolo._ensure_built().load_state_dict(state_dict_from_jax(variables), strict=True)
    got = yolo.predict(images, conf=0.25, iou=0.7, batch_size=4)

    assert len(got) == len(want) == 3
    assert sum(len(d) for d in want) > 20  # NMS had real work
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.classes, w.classes)
        # f32 end to end, but the letterbox resize differs by a u8 level at
        # some pixels (torch vs cv2 fixed-point bilinear): boxes agree to
        # 0.01 px (measured 3.8e-3), scores to 1e-4 (measured 6e-6)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=0.01)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-4)

"""The port's w8a8 (``models/quant.py``, ``ops/kernels/int8_conv.py``)
against the JAX package's ``models/quant.py`` on the CPU: the int8 conv's
plain version against ``_int8_conv_call`` at the kernel's edge shapes (s32
sums exactly equal, f32 outputs bit-identical); which convs quantize, for
all three families; calibration and the int8 forward of yolo11n (nc 3, 64
px, f32) on the same weights and numpy-made images; then the port alone:
int8 bundles, the Engine and ``val(int8=True)``. The JAX side runs with
``jax.disable_jit()``: op by op it computes what its jitted program
computes, and a CPU compile of a whole detector costs more than the test."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from jax import lax

from deal_yolo_daya_tpu.models.quant import _conv_paths, _int8_conv_call
from deal_yolo_daya_tpu.models.quant import quantize_int8 as jax_quantize_int8
from deal_yolo_daya_tpu.models.quant import quantized_apply
from deal_yolo_daya_tpu.models.yolo11 import fuse_conv_bn as jax_fuse_conv_bn
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import fuse_conv_bn, make_detector, state_dict_from_jax
from deal_yolo_daya_tpu_torch.models import quant
from deal_yolo_daya_tpu_torch.models.weights import qtree_from_jax
from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as s8
from deal_yolo_daya_tpu_torch.ops.kernels.int8_conv import (int8_conv_plain, pack_weight,
                                                            unpack_weight)
from deal_yolo_daya_tpu_torch.serve import Engine
from deal_yolo_daya_tpu_torch.train.trainer import Trainer, make_config
from tests.test_torch_port_torch_import import _tree
from tests.test_torch_port_serve import _write_dataset
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------- the s8 conv

# (B, H, W, Cin, Cout, k, stride): the stem (Cin 3, K = 27, stride 2), a 1x1
# conv whose Cout is no multiple of the kernel's 64-wide tile, B = 1 with an
# odd image, a K of 2304 (9 x 256) and stride 2
EDGES = [(2, 16, 16, 3, 16, 3, 2), (1, 8, 8, 64, 67, 1, 1), (1, 9, 7, 16, 32, 3, 1),
         (2, 10, 10, 256, 24, 3, 2)]


def _conv_inputs(b, h, w, cin, cout, k, seed):
    """Activations with values on the quantizer's edges: saturating (beyond
    +-127 steps), exactly at +-127 steps and at k + 0.5 steps of a_scale
    (ties of the rounding, half to even), beside normal values."""
    rng = np.random.default_rng(seed)
    a_scale = np.float32(0.05)
    x = rng.normal(0, 2.0, (b, h, w, cin)).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    n = flat.size // 8
    flat[idx[:n]] = rng.choice([-200.0, 200.0, -127.0, 127.0], n) * a_scale
    flat[idx[n:2 * n]] = (rng.integers(-127, 127, n) + 0.5).astype(np.float32) * a_scale
    w_int8 = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)  # HWIO
    w_scale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    return x, w_int8, w_scale, a_scale


@pytest.mark.parametrize("shape", EDGES, ids=[f"cin{s[3]}-cout{s[4]}-k{s[5]}-s{s[6]}"
                                              for s in EDGES])
def test_int8_conv_plain_equals_jax(shape):
    """s32 sums exactly equal to XLA's int8 conv on JAX's own quantized
    input; f32 outputs bit-identical to ``_int8_conv_call``."""
    b, h, w, cin, cout, k, s = shape
    x, w_int8, w_scale, a_scale = _conv_inputs(b, h, w, cin, cout, k, seed=sum(shape))
    pad = k // 2
    conv = nn.Conv(cout, (k, k), strides=s, padding=((pad, pad), (pad, pad)), use_bias=False)
    q = {"w_int8": jnp.asarray(w_int8), "w_scale": jnp.asarray(w_scale),
         "a_scale": jnp.float32(a_scale)}
    want_y = np.asarray(_int8_conv_call(conv, q, jnp.asarray(x)))
    xq = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / q["a_scale"])), -127, 127).astype(jnp.int8)
    want_acc = np.asarray(lax.conv_general_dilated(
        xq, q["w_int8"], (s, s), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))

    packed = pack_weight(torch.from_numpy(w_int8).permute(3, 2, 0, 1))
    assert packed.shape == (cout, -(-k * k * cin // 32) * 32)
    assert torch.equal(unpack_weight(packed, cin, k),
                       torch.from_numpy(w_int8).permute(3, 2, 0, 1))
    inv_a = float(np.float32(1.0) / a_scale)
    scale = torch.from_numpy(w_scale) * torch.tensor(a_scale)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view, channels_last strides
    y, acc = int8_conv_plain(xt, packed, scale, inv_a, k, s)
    assert acc.dtype == torch.int32 and np.abs(want_acc).max() > 2 ** 14
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), want_y)


def test_the_kernel_path_takes_only_cuda_tensors():
    """On the CPU ``int8_conv_bn`` takes the plain version; the kernel's
    launch refuses a CPU tensor instead of falling back."""
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 8, 5, 5)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (16, 8, 3, 3)).astype(
        np.int8))
    packed, scale, bias = pack_weight(w), torch.full((16,), 1e-3), torch.zeros(16)
    assert torch.equal(s8.int8_conv_bn(x, packed, scale, bias, 20.0, 3, 1, False),
                       int8_conv_plain(x, packed, scale, 20.0, 3, 1)[0])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        s8.launch(x, packed, scale, bias, 20.0, 3, 1, False)


# ---------------------------------------------------------------- which convs

@pytest.mark.parametrize("family", ["yolo11", "yolov8", "yolo12"])
def test_quantized_convs_are_jax_conv_paths(family):
    _, variables = _tree(family, "n", 3, seed=0)
    dense = {p: k for p, k in _conv_paths(variables["params"]).items() if k.shape[2] > 1}
    want = qtree_from_jax({p: {"w_int8": np.zeros(k.shape, np.int8),
                               "w_scale": np.ones(k.shape[-1], np.float32), "a_scale": 1.0}
                           for p, k in dense.items()})
    model = make_detector(family, "n", 3)
    assert quant.conv_names(model) == set(want)
    for name, q in want.items():  # the key map lands on convs of the same shape
        assert model.get_submodule(name).weight.shape == q["w_int8"].shape, name


# ---------------------------------------------------------------- calibration

@pytest.fixture(scope="module")
def quantized():
    """yolo11n nc 3 at 64 px, f32: the JAX qtree and the port's from the same
    BN-folded weights and two numpy-made calibration batches (/ 255). The
    port's model takes JAX's fold (the BN an identity carrying the bias) and
    folds it again, which changes no bit: its own fold of the unfolded
    weights differs by an ulp in a few kernels (torch.sqrt on the CPU is not
    always correctly rounded), and the point here is the quantizer."""
    model, variables = _tree("yolo11", "n", 3, seed=3)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (2, IMGSZ, IMGSZ, 3)).astype(np.float32) / 255.0
               for _ in range(2)]
    with jax.disable_jit():
        fused = jax_fuse_conv_bn(variables)
        jax_qtree = jax_quantize_int8(model, fused, [jnp.asarray(b) for b in batches])
    port = make_detector("yolo11", "n", 3)
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, fused)),
                         strict=True)
    port_fused = fuse_conv_bn(port.eval())
    port_qtree = quant.quantize_int8(port_fused, [torch.from_numpy(b).permute(0, 3, 1, 2)
                                                  for b in batches])
    return model, fused, jax_qtree, port_fused, port_qtree, batches


def test_calibration_equals_jax(quantized):
    """The same convs; w_int8 and w_scale bit-identical (numpy on the same
    folded f32 kernels); a_scale within 1e-4 relative: the absmax is of f32
    activations that the two frameworks round differently deep in the net
    (measured 1.4e-7, an ulp)."""
    _, _, jax_qtree, _, port_qtree, _ = quantized
    want = qtree_from_jax(jax_qtree)
    assert sorted(port_qtree) == sorted(want) and len(want) > 60
    for name, q in want.items():
        got = port_qtree[name]
        assert got["w_int8"].dtype == torch.int8, name
        assert torch.equal(got["w_int8"], q["w_int8"]), name
        assert torch.equal(got["w_scale"], q["w_scale"]), name
        torch.testing.assert_close(got["a_scale"], q["a_scale"], rtol=1e-4, atol=0, msg=name)


def test_int8_forward_equals_jax_quantized_apply(quantized):
    """The port's int8 model on the JAX qtree (``qtree_from_jax``) against
    ``quantized_apply`` on the same batch: raw head outputs within 2e-3 of
    each level's largest magnitude. Both quantize the same f32 activations,
    but an activation that the two frameworks round an ulp apart can land on
    the other side of a rounding edge and move by one quantization step;
    measured 1.7e-7 (no activation flipped at this seed)."""
    model, fused, jax_qtree, port_fused, _, batches = quantized
    with jax.disable_jit():
        want = quantized_apply(model, fused, jax_qtree)(jnp.asarray(batches[0]))
    net = quant.quantized_model(port_fused, qtree_from_jax(jax_qtree), torch.float32, "cpu")
    with torch.no_grad():
        got = net.net(torch.from_numpy(batches[0]).permute(0, 3, 1, 2))
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            w = np.asarray(w)
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                       atol=2e-3 * np.abs(w).max())


# ---------------------------------------------------------------- the port alone

@pytest.fixture(scope="module")
def int8_handle():
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(64, 64), (48, 80), (90, 50), (64, 40)]]
    yolo = YOLO("yolo11n", nc=3, imgsz=IMGSZ, device="cpu")
    with torch.no_grad():  # class biases 0: conf 0.01 leaves NMS work
        for i in range(3):
            yolo._ensure_built().layer(23).cv3[i][2].bias.zero_()
    return yolo.quantize_int8(images, batch_size=2), images


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.classes, w.classes)


def test_int8_export_round_trip_is_bit_for_bit(int8_handle, tmp_path):
    yolo, images = int8_handle
    out = yolo.export(tmp_path / "bundle")
    assert json.loads((out / "meta.json").read_text())["int8"] is True
    loaded = YOLO.from_export(out, device="cpu")
    assert sorted(loaded._quant) == sorted(yolo._quant)
    want = yolo.predict(images, conf=0.01)
    assert sum(len(d) for d in want) > 10
    _equal(loaded.predict(images, conf=0.01), want)


def test_engine_serves_the_int8_model(int8_handle):
    yolo, images = int8_handle
    eng = Engine(yolo, max_batch=4, max_wait_ms=2000.0, conf=0.01, iou=0.7)
    assert isinstance(eng._net, quant.Int8Detector)
    eng.warmup([4])
    with eng:
        futs = [eng.submit(im) for im in images]
        got = [f.result(timeout=120) for f in futs]
    _equal(got, yolo.predict(images, conf=0.01, batch_size=4))


def test_val_int8_scores_the_int8_model(int8_handle, tmp_path, monkeypatch):
    yolo, _ = int8_handle
    data = str(_write_dataset(tmp_path / "ds", n_val=4))
    kw = dict(imgsz=IMGSZ, batch=4, amp=False, conf=0.001, project=str(tmp_path / "runs"))
    fresh = YOLO("yolo11n", nc=3, imgsz=IMGSZ, device="cpu")
    with pytest.raises(ValueError, match="quantize_int8"):
        fresh.val(data, int8=True, **kw)
    calls = []
    forward = quant.Int8Detector.forward
    monkeypatch.setattr(quant.Int8Detector, "forward",
                        lambda self, x: calls.append(x.shape) or forward(self, x))
    metrics = yolo.val(data, int8=True, name="int8", **kw)
    assert calls == [(4, 3, IMGSZ, IMGSZ)]  # the one val batch went through the int8 model
    assert {"map50", "map"} <= set(metrics)
    # the same validation with the int8 model handed to the Trainer directly
    net = yolo._fused_model()
    trainer = Trainer(make_config("yolo11n", data, device="cpu", name="direct", **kw),
                      init_state_dict=yolo._model.state_dict(),
                      eval_apply=lambda im: net(im.permute(0, 3, 1, 2).float()))
    want, _ = trainer.validate()
    assert metrics["map"] == want["map"] and metrics["map50"] == want["map50"]

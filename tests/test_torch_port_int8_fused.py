"""The fused w8a8 ConvBN (``ops/kernels/int8_conv.py::int8_conv_bn``, the
quantized ``ConvBN`` of ``models/quant.py``) against the JAX package on the
CPU: its plain version against ``_int8_conv_call`` followed by the folded
bias and SiLU, in f32 and bf16, with and without act, 1x1 and 3x3, strides 1
and 2; which modules ``quantized_model`` replaces; a qtree and bundle in the
format of the unfused port still load; the kernel wrapper's refusals and
its plan of route and shared memory (pure functions of the shapes); an
``Int8ConvBN`` forward is the wrapper's call alone. Small shapes, numpy-made
inputs."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from deal_yolo_daya_tpu.models.quant import _int8_conv_call
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import fuse_conv_bn, make_detector, quant
from deal_yolo_daya_tpu_torch.models.blocks import ConvBN
from deal_yolo_daya_tpu_torch.ops.kernels import int8_conv as s8
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (k, stride): the 1x1 and 3x3 convs of yolo11n, 3x3 at both strides
GEOMETRY = [(1, 1), (3, 1), (3, 2)]


def _inputs(cin, cout, k, seed, h=9, w=7):
    """Activations on the quantizer's edges (saturating, exactly +-127 steps,
    the k + 0.5 ties) beside normal values; int8 HWIO weights; per-channel
    scales; a folded bias."""
    rng = np.random.default_rng(seed)
    a_scale = np.float32(0.05)
    x = rng.normal(0, 2.0, (2, h, w, cin)).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    n = flat.size // 8
    flat[idx[:n]] = rng.choice([-200.0, 200.0, -127.0, 127.0], n) * a_scale
    flat[idx[n:2 * n]] = (rng.integers(-127, 127, n) + 0.5).astype(np.float32) * a_scale
    w_int8 = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    bias = rng.normal(0, 2.0, cout).astype(np.float32)
    return x, w_int8, w_scale, a_scale, bias


def _jax_convbn(x, w_int8, w_scale, a_scale, bias, k, s, act, jdtype):
    """The JAX package's quantized ConvBN, BN folded: the int8 conv call,
    the bias added in the activations' dtype, then SiLU."""
    pad = k // 2
    conv = nn.Conv(w_int8.shape[-1], (k, k), strides=s, padding=((pad, pad), (pad, pad)),
                   use_bias=False)
    q = {"w_int8": jnp.asarray(w_int8), "w_scale": jnp.asarray(w_scale),
         "a_scale": jnp.float32(a_scale)}
    z = _int8_conv_call(conv, q, jnp.asarray(x, jdtype)) + jnp.asarray(bias, jdtype)
    return np.asarray((jax.nn.silu(z) if act else z).astype(jnp.float32))


def _port_convbn(x, w_int8, w_scale, a_scale, bias, k, s, act, tdtype):
    packed = s8.pack_weight(torch.from_numpy(w_int8).permute(3, 2, 0, 1))
    scale = torch.from_numpy(w_scale) * torch.tensor(a_scale)
    inv_a = float(np.float32(1.0) / a_scale)
    xt = torch.from_numpy(x).to(tdtype).permute(0, 3, 1, 2)
    out, acc = s8.int8_conv_bn_plain(xt, packed, scale, torch.from_numpy(bias).to(tdtype),
                                     inv_a, k, s, act)
    assert out.dtype == tdtype and acc.dtype == torch.int32
    return out.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("act", [True, False], ids=["silu", "noact"])
@pytest.mark.parametrize("geometry", GEOMETRY, ids=[f"k{k}s{s}" for k, s in GEOMETRY])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_plain_equals_jax_quantized_convbn(dtype, geometry, act):
    """Without act the outputs are bit-identical: the same quantizer, exact
    s32 sums, one f32 multiply and one add, each rounded to the dtype. With
    SiLU, JAX takes x * logistic(x) where PyTorch takes x / (1 + exp(-x))
    in f32 and rounds once: the same function, rounded differently, so
    within 4 f32 ulps (rtol 5e-7) in f32; in bf16 XLA's CPU SiLU rounds its
    intermediate results to bf16 too (up to 2^-9 each; 0.0092 measured), so
    within 2^-6 relative."""
    k, s = geometry
    tdtype, jdtype = DTYPES[dtype]
    args = _inputs(16, 24, k, seed=k * 10 + s)
    want = _jax_convbn(*args, k, s, act, jdtype)
    got = _port_convbn(*args, k, s, act, tdtype)
    assert got.shape == want.shape and np.isfinite(got).all()
    if not act:
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 5e-7 if dtype == "f32" else 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-30)


@pytest.mark.parametrize("act", [True, False], ids=["silu", "noact"])
def test_fused_plain_equals_the_unfused_convbn(act):
    """The fused plain version rounds where the unfused port rounded: the
    conv's output in the dtype, then ``+ bias``, then ``F.silu`` (bf16)."""
    x, w_int8, w_scale, a_scale, bias = _inputs(32, 16, 3, seed=4)
    packed = s8.pack_weight(torch.from_numpy(w_int8).permute(3, 2, 0, 1))
    scale = torch.from_numpy(w_scale) * torch.tensor(a_scale)
    inv_a = float(np.float32(1.0) / a_scale)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    b = torch.from_numpy(bias).to(torch.bfloat16)
    y = s8.int8_conv_plain(xt, packed, scale, inv_a, 3, 2)[0] + b.view(1, -1, 1, 1)
    want = F.silu(y) if act else y
    got = s8.int8_conv_bn(xt, packed, scale, b, inv_a, 3, 2, act)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------- the model

def _dummy_qtree(model):
    return {name: {"w_int8": torch.zeros(model.get_submodule(name).weight.shape,
                                         dtype=torch.int8),
                   "w_scale": torch.ones(model.get_submodule(name).weight.shape[0]),
                   "a_scale": torch.tensor(np.float32(0.5))}
            for name in quant.conv_names(model)}


@pytest.mark.parametrize("family", ["yolo11", "yolov8", "yolo12"])
def test_quantized_model_replaces_exactly_the_convbns_of_conv_names(family):
    """Each ConvBN of ``conv_names`` becomes an ``Int8ConvBN`` keeping its
    act; depthwise ConvBNs (yolo11's and yolo12's heads; yolov8 has none)
    and the bare detect-head logit convs stay."""
    fused = fuse_conv_bn(make_detector(family, "n", 3).eval())
    qtree = _dummy_qtree(fused)
    net = quant.quantized_model(fused, qtree, torch.float32, "cpu").net
    int8 = {n: m for n, m in net.named_modules() if isinstance(m, quant.Int8ConvBN)}
    assert set(int8) == {name[:-len(".conv")] for name in qtree}
    for name, mod in int8.items():
        assert mod.act == fused.get_submodule(name).act, name
    left = {n: m for n, m in net.named_modules() if isinstance(m, ConvBN)}
    assert all(m.conv.groups > 1 for m in left.values())
    assert bool(left) == (family != "yolov8")
    logits = [n for n, m in net.named_modules()
              if isinstance(m, torch.nn.Conv2d) and not n.endswith(".conv")]
    assert logits and all(isinstance(net.get_submodule(n), torch.nn.Conv2d) for n in logits)


def test_quantized_model_refuses_a_key_that_is_no_convbn_conv():
    fused = fuse_conv_bn(make_detector("yolo11", "n", 3).eval())
    qtree = _dummy_qtree(fused)
    name = next(iter(qtree))
    with pytest.raises(ValueError, match="no ConvBN's conv"):
        quant.quantized_model(fused, {name[:-len(".conv")] + ".bn": qtree[name]},
                              torch.float32, "cpu")


def test_a_qtree_and_bundle_of_the_unfused_format_still_load(tmp_path):
    """A bundle's ``quant.pt`` holds the qtree keyed by the JAX conv paths
    ("<ConvBN>.conv"), as the unfused port wrote it: ``from_export`` loads
    it into the fused modules, which predict as the exporting handle."""
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(2)]
    yolo = YOLO("yolo11n", nc=3, imgsz=64, device="cpu").quantize_int8(images, batch_size=2)
    out = yolo.export(tmp_path / "bundle")
    qtree = torch.load(out / "quant.pt", map_location="cpu", weights_only=True)
    assert all(k.endswith(".conv") and set(v) == {"w_int8", "w_scale", "a_scale"}
               for k, v in qtree.items())
    # written again as plain tensors under the same keys: the older format
    torch.save({k: {f: v[f].clone() for f in ("w_int8", "w_scale", "a_scale")}
                for k, v in qtree.items()}, out / "quant.pt")
    loaded = YOLO.from_export(out, device="cpu")
    net = loaded._fused_model().net
    assert sum(isinstance(m, quant.Int8ConvBN) for m in net.modules()) == len(qtree)
    want = yolo.predict(images, conf=0.01)
    got = loaded.predict(images, conf=0.01)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)


# ---------------------------------------------------------------- the wrapper

def _args(cin=16, cout=8, k=3, dtype=torch.float32):
    x = torch.zeros((1, cin, 5, 5), dtype=dtype)
    packed = s8.pack_weight(torch.zeros((cout, cin, k, k), dtype=torch.int8))
    return x, packed, torch.full((cout,), 1e-3), torch.zeros(cout, dtype=dtype)


def test_the_wrapper_launches_only_for_cuda_tensors():
    x, packed, scale, bias = _args()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        s8.launch(x, packed, scale, bias, 20.0, 3, 1, True)


BAD = {
    "f16": lambda: (_args()[0].half(),) + _args()[1:3] + (_args()[3].half(),),
    "3d": lambda: (_args()[0][0],) + _args()[1:],
    "kp": lambda: (_args()[0], s8.pack_weight(torch.zeros((8, 16, 1, 1), dtype=torch.int8)))
    + _args()[2:],
    "scale": lambda: _args()[:2] + (torch.ones(8, dtype=torch.float64), _args()[3]),
    "bias_dtype": lambda: _args()[:3] + (torch.zeros(8, dtype=torch.bfloat16),),
    "bias_shape": lambda: _args()[:3] + (torch.zeros(9),),
}


@pytest.mark.parametrize("case", list(BAD))
def test_the_wrapper_raises_for_what_no_path_takes(case):
    """Shapes and types no kernel path takes raise before any device check."""
    with pytest.raises(ValueError, match="int8_conv: "):
        s8.launch(*BAD[case](), 20.0, 3, 1, True)


def _yolo11n_shapes():
    model = make_detector("yolo11", "n", 80)
    return [(conv.in_channels, conv.out_channels, conv.kernel_size[0], conv.stride[0])
            for conv in (model.get_submodule(n) for n in sorted(quant.conv_names(model)))]


def test_the_paths_of_yolo11n():
    """72 of yolo11n's 74 quantized convs take the wgmma kernel (67 with the
    halo by TMA, the 5 whose ring does not fit beside their weight tile by
    the threads' own loads); the stem (Cin 3) and the Cin 8 conv the narrow
    one. Each plan lies within shared memory, its regions in order."""
    shapes = _yolo11n_shapes()
    routes = [s8.path(*sh) for sh in shapes]
    assert len(routes) == 74
    assert routes.count("tma") == 67 and routes.count("direct") == 5
    assert sorted(sh[0] for sh, r in zip(shapes, routes) if r == "narrow") == [3, 8]
    for sh in shapes:
        pl = s8.plan(*sh)
        if pl.route == "narrow":
            continue
        assert pl.nbytes <= s8.SMEM_LIMIT and pl.nt >= min(sh[1], 64)
        assert (pl.stages * pl.stage <= pl.off_a < pl.off_a + 2 * pl.a_step <= pl.off_b
                < pl.off_tab < pl.off_sc < pl.off_qt <= pl.off_bar < pl.nbytes)
        assert pl.off_a % 128 == 0 and pl.a_step % 128 == 0 and pl.box % 128 == 0
    # the heaviest conv: a box of 64 channels x 17 x 17 pixels (36992 bytes) a
    # stage; two A tiles of 4 planes of 17 x 2 x 9 pixels (19584 each); K 576
    # bytes a row of 64 (36864), 18 steps of the table (144), scale|bias
    # (512), 289 x 4 items of the table (4624), two barriers, 128 bytes to
    # align the base. One block an SM with one stage or two: two stages.
    pl = s8.plan(64, 64, 3, 2)
    assert (pl.route, pl.nt, pl.stages, pl.cb, pl.stage) == ("tma", 64, 2, 64, 36992)
    assert pl.nbytes == 2 * 36992 + 2 * 19584 + 36864 + 144 + 512 + 4624 + 16 + 128
    # a 1x1 tile at 256 -> 64: a second stage would cost the SM its second block
    assert s8._blocks(s8.plan(256, 64, 1, 1).nbytes) == 2
    assert s8.plan(256, 64, 1, 1).stages == 1
    assert s8.plan(256, 64, 1, 1, stages=2, keep_blocks=False).stages == 2
    assert s8.plan(1024, 1024, 3, 1).route == "narrow"


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_a_base_off_16_bytes_takes_the_direct_route(esize):
    """TMA needs a 16-byte aligned base and pixel stride: such inputs keep
    the wgmma kernel with the threads' own loads, at the same tiles."""
    for sh in _yolo11n_shapes():
        tma, direct = s8.plan(*sh, esize=esize), s8.plan(*sh, esize=esize, aligned=False)
        assert direct.route == ("narrow" if tma.route == "narrow" else "direct")
        assert direct.stages == 0 and direct.nbytes <= s8.SMEM_LIMIT
    x = torch.zeros((2, 64, 5, 7)).contiguous(memory_format=torch.channels_last)
    assert s8.plan_for(x, 64, 3, 1).route == "tma"
    assert s8.plan_for(torch.zeros((2, 64, 5, 7)), 64, 3, 1).route == "tma"  # copied first
    flat = torch.zeros(2 * 5 * 7 * 64 + 1)
    odd = flat[1:].view(2, 5, 7, 64).permute(0, 3, 1, 2)  # a base 4 bytes off
    assert s8.pixel_stride(odd) == 64 and s8.plan_for(odd, 64, 3, 1).route == "direct"


def test_an_int8convbn_forward_is_the_kernel_call_alone(monkeypatch):
    """A quantized ConvBN hands the whole ConvBN (conv, folded bias, SiLU)
    to ``int8_conv_bn`` and returns its result untouched: no bias add or
    SiLU of its own, with and without act."""
    fused = fuse_conv_bn(make_detector("yolo11", "n", 3).eval())
    net = quant.quantized_model(fused, _dummy_qtree(fused), torch.float32, "cpu").net
    calls = []

    def fake(x, packed, scale, bias, inv_a, k, stride, act):
        calls.append((bias, act))
        return torch.full((1,), float(len(calls)))

    monkeypatch.setattr(s8, "int8_conv_bn", fake)
    mods = [m for m in net.modules() if isinstance(m, quant.Int8ConvBN)]
    assert {m.act for m in mods} == {True, False}
    for i, mod in enumerate(mods):
        out = mod(torch.zeros((1, 1, 1, 1)))
        assert out.item() == i + 1 and calls[-1][0] is mod.bias and calls[-1][1] is mod.act


def test_pixel_stride_reads_channel_slices_in_place():
    x = torch.zeros((2, 64, 5, 7)).contiguous(memory_format=torch.channels_last)
    assert s8.pixel_stride(x) == 64
    assert s8.pixel_stride(x[:, 32:]) == 64 and s8.pixel_stride(x[:, :16]) == 64
    assert s8.pixel_stride(torch.zeros((2, 64, 5, 7))) is None  # NCHW: made channels_last

"""The space-to-depth stride-2 conv on the CPU: ``ConvBN(spd=True)`` and
``SPD_STRIDE2`` (``models/blocks.py::spd_conv2``) against the JAX package's
``ConvBN(spd=True)`` (``_SPDConv2``) with the same weights, and against the
port's direct conv, at JAX ``tests/test_model.py::
test_spd_lowering_equivalence``'s shapes ((H, C, O) = (16, 3, 16), the stem,
and (8, 16, 32)).

Bars, f32: forwards to atol 1e-5 (the JAX test's); the weight and input
gradients of the two lowerings to 1e-5 of their largest entry; the BN fold
of an spd ConvBN equal bit for bit to the direct one's (it reads the same
``conv.weight``), its folded forward to atol 1e-5."""

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.models import blocks
from deal_yolo_daya_tpu_torch.models.blocks import ConvBN, spd_conv2
from deal_yolo_daya_tpu_torch.models.registry import make_detector
from deal_yolo_daya_tpu_torch.models.yolo11 import fuse_conv_bn, init_weights

SHAPES = [(16, 3, 16), (8, 16, 32)]
ATOL = 1e-5


def _module(c, o, spd, seed=0):
    """A ConvBN(c -> o, 3x3, stride 2) with random weights and statistics."""
    rng = np.random.default_rng(seed)
    m = ConvBN(c, o, 3, 2, spd=spd)
    m.load_state_dict({
        "conv.weight": torch.from_numpy(rng.normal(0, 0.3, (o, c, 3, 3)).astype(np.float32)),
        "bn.weight": torch.from_numpy(rng.uniform(0.5, 1.5, o).astype(np.float32)),
        "bn.bias": torch.from_numpy(rng.uniform(-0.5, 0.5, o).astype(np.float32)),
        "bn.running_mean": torch.from_numpy(rng.uniform(-0.3, 0.3, o).astype(np.float32)),
        "bn.running_var": torch.from_numpy(rng.uniform(0.5, 1.5, o).astype(np.float32))})
    return m


def _input(h, c, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (2, c, h, h))
                            .astype(np.float32))


@pytest.mark.parametrize("h,c,o", SHAPES)
def test_spd_matches_jax_spd_conv(h, c, o):
    """The eval forward of the port's ConvBN(spd=True) against the JAX
    ConvBN(spd=True) (and the JAX direct one) on the same weights."""
    import jax
    import jax.numpy as jnp

    from deal_yolo_daya_tpu.models.blocks import ConvBN as JaxConvBN

    port = _module(c, o, spd=True).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = {"params": {"conv": {"kernel": sd["conv.weight"].transpose(2, 3, 1, 0)},
                            "bn": {"scale": sd["bn.weight"], "bias": sd["bn.bias"]}},
                 "batch_stats": {"bn": {"mean": sd["bn.running_mean"],
                                        "var": sd["bn.running_var"]}}}
    x = _input(h, c)
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    want = np.asarray(JaxConvBN(o, 3, 2, spd=True).apply(variables, xj, train=False))
    direct = np.asarray(JaxConvBN(o, 3, 2, spd=False).apply(variables, xj, train=False))
    with torch.no_grad():
        got = port(x).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, h // 2, h // 2, o)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, direct, atol=ATOL)


@pytest.mark.parametrize("h,c,o", SHAPES)
def test_spd_matches_direct_conv_forward_and_backward(h, c, o):
    """Train mode (batch statistics), forward and backward: the spd lowering
    against the direct conv, from the same module state."""
    outs = []
    for spd in (True, False):
        m = _module(c, o, spd).train()
        x = _input(h, c).requires_grad_()
        w = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (2, o, h // 2, h // 2))
                             .astype(np.float32))
        y = m(x)
        (y * w).sum().backward()
        outs.append((y.detach(), x.grad, m.conv.weight.grad, m.bn.running_mean.clone()))
    (ys, dxs, dws, rms), (yd, dxd, dwd, rmd) = outs
    np.testing.assert_allclose(ys, yd, atol=ATOL)
    np.testing.assert_allclose(rms, rmd, atol=ATOL)
    for got, want in ((dxs, dxd), (dws, dwd)):
        assert (got - want).abs().max() <= ATOL * want.abs().max()


@pytest.mark.parametrize("h,c,o", SHAPES)
def test_bn_fold_of_spd_is_unchanged(h, c, o):
    """The fold reads the same conv.weight: equal bit for bit to the direct
    ConvBN's fold, and the folded spd forward (conv bias added after the
    2x2 conv) equals the folded direct one."""
    spd, direct = fuse_conv_bn(_module(c, o, True).eval()), fuse_conv_bn(_module(c, o, False).eval())
    assert isinstance(spd.bn, torch.nn.Identity) and spd.conv.bias is not None
    for k, v in direct.state_dict().items():
        assert torch.equal(spd.state_dict()[k], v), k
    x = _input(h, c)
    with torch.no_grad():
        np.testing.assert_allclose(spd(x), direct(x), atol=ATOL)
        np.testing.assert_allclose(spd(x), _module(c, o, False).eval()(x), atol=ATOL)


def test_spd_stride2_switch_takes_every_eligible_conv(monkeypatch):
    """``SPD_STRIDE2`` sends every stride-2 3x3 ungrouped ConvBN on an even
    input through ``spd_conv2`` (yolo11n: the stem and the six other
    downsampling convs at 64 px), and the detector's outputs stay those of
    the direct convs; odd inputs, stride 1 and grouped convs stay direct."""
    calls = []

    def counted(x, weight):
        calls.append(tuple(weight.shape))
        return spd_conv2(x, weight)

    monkeypatch.setattr(blocks, "spd_conv2", counted)
    model = init_weights(make_detector("yolo11", "n", 2), 0).eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        direct = model(x)
        monkeypatch.setattr(blocks, "SPD_STRIDE2", True)
        spd = model(x)
    assert len(calls) == 7 and calls[0] == (16, 3, 3, 3)
    for a, b in zip(direct[0] + direct[1], spd[0] + spd[1]):
        np.testing.assert_allclose(b, a, atol=1e-4)
    calls.clear()
    with torch.no_grad():
        ConvBN(4, 8, 3, 2, spd=True).eval()(torch.zeros(1, 4, 9, 9))     # odd
        ConvBN(4, 8, 3, 1, spd=True).eval()(torch.zeros(1, 4, 8, 8))     # stride 1
        ConvBN(4, 4, 3, 2, g=4, spd=True).eval()(torch.zeros(1, 4, 8, 8))  # grouped
    assert calls == []

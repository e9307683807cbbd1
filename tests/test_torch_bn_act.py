"""Train-mode BatchNorm with its SiLU (``ops/kernels/batch_norm_act.py``) on
the CPU: the plain route of ``BatchNormAct`` against PyTorch's own
``native_batch_norm`` with flax's running update and a separate
``F.silu`` (the port's BatchNorm before the Function), in float64; its
gradients by ``gradcheck``; the running statistics under
``rematerialized``; which ConvBN calls take it; and the kernels' launch
geometry and layout tests at the train cells' shapes. The kernels run only
on the card (chip_smoke phase 45 holds them to the plain version there)."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from deal_yolo_daya_tpu_torch.models import blocks
from deal_yolo_daya_tpu_torch.models.blocks import BN_EPS, BN_MOMENTUM, ConvBN, rematerialized
from deal_yolo_daya_tpu_torch.ops.kernels import batch_norm_act as bna
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

F64 = torch.float64


def _reference(x, weight, bias, running_mean, running_var, act):
    """The port's train-mode BatchNorm before the Function: PyTorch's
    ``native_batch_norm`` on the batch, flax's update of the running
    statistics toward the batch mean and the biased variance, then SiLU."""
    y, mean, invstd = torch.native_batch_norm(x, weight, bias, None, None, True, 0.0, BN_EPS)
    with torch.no_grad():
        var = invstd.pow(-2) - BN_EPS
        running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
    return F.silu(y) if act else y


def _inputs(seed, shape=(3, 6, 5, 4), channels_last=True):
    """x with channel means away from 0, weight, bias, running statistics;
    all float64."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, dtype=F64) * 2.0 \
        + torch.randn((1, c, 1, 1), generator=g, dtype=F64) * 3.0
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.rand((c,), generator=g, dtype=F64) + 0.5
    bias = torch.randn((c,), generator=g, dtype=F64)
    stats = (torch.randn((c,), generator=g, dtype=F64), torch.rand((c,), generator=g, dtype=F64) + 0.5)
    return x, weight, bias, stats


@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("act", [True, False], ids=["silu", "no_act"])
def test_plain_function_matches_batch_norm_and_silu(act, channels_last):
    x, weight, bias, (rm, rv) = _inputs(1, channels_last=channels_last)
    rm_ref, rv_ref = rm.clone(), rv.clone()
    for step in range(2):  # the running statistics after one and after two updates
        xs = x * (1.0 + step)
        z = bna.batch_norm_act(xs, weight, bias, rm, rv, act, True, BN_EPS, BN_MOMENTUM)
        ref = _reference(xs, weight, bias, rm_ref, rv_ref, act)
        assert z.dtype == F64 and z.shape == xs.shape
        torch.testing.assert_close(z, ref, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(rm, rm_ref, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(rv, rv_ref, rtol=1e-12, atol=1e-12)
    # the batch statistics the Function keeps: the mean and the biased variance
    z, mean, invstd = bna.forward_plain(x, weight, bias, rm.clone(), rv.clone(), act, False,
                                        BN_EPS, BN_MOMENTUM)
    var, mu = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(mean, mu, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(invstd, (var + BN_EPS).rsqrt(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("act", [True, False], ids=["silu", "no_act"])
def test_plain_function_gradients_match_autograd(act):
    x, weight, bias, (rm, rv) = _inputs(2)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    z = bna.batch_norm_act(*leaves, rm.clone(), rv.clone(), act, True, BN_EPS, BN_MOMENTUM)
    ref_leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    ref = _reference(*ref_leaves, rm.clone(), rv.clone(), act)
    dz = torch.randn(z.shape, generator=torch.Generator().manual_seed(3), dtype=F64)
    got = torch.autograd.grad(z, leaves, dz)
    want = torch.autograd.grad(ref, ref_leaves, dz)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("act", [True, False], ids=["silu", "no_act"])
def test_plain_function_gradcheck(act, channels_last):
    x, weight, bias, (rm, rv) = _inputs(4, (2, 3, 3, 2), channels_last)
    leaves = [t.requires_grad_() for t in (x, weight, bias)]

    def fn(x_, w_, b_):
        return bna.batch_norm_act(x_, w_, b_, rm, rv, act, False, BN_EPS, BN_MOMENTUM)

    assert torch.autograd.gradcheck(fn, leaves)
    before = (rm.clone(), rv.clone())
    fn(*leaves)
    assert torch.equal(rm, before[0]) and torch.equal(rv, before[1])  # update_stats off


def test_rematerialized_moves_the_running_statistics_once():
    """A checkpointed ConvBN stack recomputes its forward in the backward
    with ``update_stats`` off: its running statistics and gradients equal
    those of the same stack run plainly."""
    torch.manual_seed(5)
    stack = nn.Sequential(ConvBN(3, 8, 3), ConvBN(8, 8, 1, act=False), ConvBN(8, 4, 3)).double()
    twin = nn.Sequential(ConvBN(3, 8, 3), ConvBN(8, 8, 1, act=False), ConvBN(8, 4, 3)).double()
    twin.load_state_dict(stack.state_dict())
    stack.train()
    twin.train()
    x = torch.randn((2, 3, 6, 6), dtype=F64)
    rematerialized(stack, x).square().sum().backward()
    twin(x).square().sum().backward()
    for (name, a), b in zip(stack.state_dict().items(), twin.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)
    for (name, a), b in zip(stack.named_parameters(), twin.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-10, atol=1e-12, msg=name)
    assert all(m.update_stats for m in stack.modules() if isinstance(m, blocks.BatchNorm))


def test_conv_bn_in_training_goes_through_the_function(monkeypatch):
    """ConvBN in train mode with no data-parallel group calls the Function
    once, with its own ``act`` and the BatchNorm's ``update_stats``; in eval
    mode, after folding, and with ``dp`` set it does not."""
    calls = []

    def recording(x, weight, bias, running_mean, running_var, act, update_stats, eps, momentum):
        calls.append((act, update_stats, eps, momentum))
        return bna.batch_norm_act(x, weight, bias, running_mean, running_var, act, update_stats,
                                  eps, momentum)

    monkeypatch.setattr(blocks, "batch_norm_act", recording)
    torch.manual_seed(6)
    x = torch.randn((2, 3, 8, 8))
    for act in (True, False):
        mod = ConvBN(3, 4, 3, act=act).train()
        calls.clear()
        z = mod(x)
        assert calls == [(act, True, BN_EPS, BN_MOMENTUM)]
        with torch.no_grad():
            y = mod.bn.running_mean  # moved once by the Function
            assert not torch.equal(y, torch.zeros_like(y))
        conv = mod.conv(x)
        mean, var = conv.mean((0, 2, 3)), conv.var((0, 2, 3), unbiased=False)
        y_ref = (conv - mean[:, None, None]) / torch.sqrt(var + BN_EPS)[:, None, None]
        torch.testing.assert_close(z, F.silu(y_ref) if act else y_ref, rtol=1e-4, atol=1e-5)
        mod.bn.update_stats = False
        calls.clear()
        mod(x)
        assert calls == [(act, False, BN_EPS, BN_MOMENTUM)]
        mod.bn.update_stats = True
        calls.clear()
        mod.eval()(x)
        mod.bn.dp = object()  # a data-parallel group takes _SyncBatchNorm instead
        mod.eval()(x)
        mod.bn.dp = None
        mod.bn = nn.Identity()
        mod.train()(x)
        assert calls == []


def test_batch_norm_in_training_goes_through_the_function(monkeypatch):
    """BatchNorm alone in train mode is the Function without the activation."""
    calls = []
    real = bna.batch_norm_act
    monkeypatch.setattr(blocks, "batch_norm_act",
                        lambda *a: calls.append(a[5:7]) or real(*a))
    bn = blocks.BatchNorm(4).train()
    bn(torch.randn((2, 4, 3, 3)))
    assert calls == [(False, True)]


# every BatchNorm shape (C, H, W) class of the train cells' b32/640 forwards:
# the widest and narrowest channels, the stem's rows, the P5 level's few rows
CELL_SHAPES = [(32, 16, 320, 320), (32, 8, 160, 160), (32, 256, 20, 20), (32, 48, 320, 320),
               (32, 576, 20, 20), (32, 384, 40, 40), (32, 24, 160, 160), (32, 72, 80, 80)]


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_row_and_channel(shape, esize):
    n, c, h, w = shape
    m = n * h * w
    p = bna.plan(m, c, esize, True)
    assert p.vec == 16 // esize and p.tcx * p.vec * esize <= bna.TILE_BYTES
    assert p.tcx * p.ry <= bna.THREADS and p.tcx * p.ry > bna.THREADS // 2
    assert p.tiles * p.tcx * p.vec >= c > (p.tiles - 1) * p.tcx * p.vec
    assert p.gy * p.rows >= m > (p.gy - 1) * p.rows
    assert p.tiles * p.gy <= 2 * bna.BLOCKS and p.tiles <= bna.MAX_TILES
    assert p.tcx & (p.tcx - 1) == 0  # a warp holds whole rows
    # one merge level up to MERGE row blocks, else the fewest groups of at most MERGE
    groups = -(-p.gy // p.group)
    assert p.group <= bna.MERGE and groups <= bna.MERGE
    assert groups == -(-p.gy // bna.MERGE) and (groups == 1) == (p.gy <= bna.MERGE)
    # rows a thread: at least MIN_ROWS where the input has them
    assert p.rows >= min(m, bna.MIN_ROWS * p.ry) or p.gy == 1


@pytest.mark.parametrize("c", [1, 3, 12, 100, 577])
def test_plan_without_vectors_masks_the_channels(c):
    p = bna.plan(1000, c, 2, False)
    assert p.vec == 1 and p.tcx <= 32 and p.tcx * p.ry <= bna.THREADS
    assert p.tiles * p.tcx >= c > (p.tiles - 1) * p.tcx


def test_row_stride_and_vector_tests():
    t = torch.randn((2, 24, 3, 5)).contiguous(memory_format=torch.channels_last)
    assert bna.row_stride(t) == 24
    assert bna.row_stride(t[:, 8:16]) == 24                  # a channel slice keeps rows
    assert bna.row_stride(torch.randn((2, 24, 3, 5))) is None  # NCHW is copied
    assert bna.row_stride(torch.randn((2, 24, 1, 1))) == 24    # one pixel: both layouts
    assert bna.row_stride(t[:, :, :, 1:]) is None            # rows not one stride apart
    assert bna.row_stride(torch.randn((4, 24))) is None
    half = torch.randn((2, 24, 3, 5), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert bna._vectors(2, 24, (half, 24))
    assert not bna._vectors(2, 24, (half[:, 4:12], 24))      # 8 bytes off a 16-byte line
    assert not bna._vectors(2, 12, (half[:, :12], 24))       # 12 channels: no whole vector


def test_the_kernel_route_refuses_what_it_does_not_take():
    x, weight, bias, (rm, rv) = _inputs(7)
    f32 = [t.float() for t in (weight, bias, rm, rv)]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bna.forward_kernel(x.float(), *f32, True, True, BN_EPS, BN_MOMENTUM)
    with pytest.raises(ValueError, match="no kernel"):
        bna.backward_kernel(x.float(), x.float(), *f32, True)

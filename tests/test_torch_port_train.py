"""The port's training step against the JAX package on the CPU: BatchNorm's
training mode, the box ops, the assigner and the detection loss, the
schedules, optimizers and EMA, and the whole yolo11n train step. Inputs are
numpy-made from seeds; f32 unless stated."""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from deal_yolo_daya_tpu.ops import boxes as jax_boxes
from deal_yolo_daya_tpu.ops import decode as jax_decode
from deal_yolo_daya_tpu.train import loss as jax_loss
from deal_yolo_daya_tpu.train import optimizer as jax_opt
from deal_yolo_daya_tpu.train.trainer import bucket_gt as jax_bucket_gt
from deal_yolo_daya_tpu_torch.models import build_yolo11, state_dict_from_jax
from deal_yolo_daya_tpu_torch.models.blocks import BatchNorm
from deal_yolo_daya_tpu_torch.ops import boxes as port_boxes
from deal_yolo_daya_tpu_torch.ops import decode as port_decode
from deal_yolo_daya_tpu_torch.train import loss as port_loss
from deal_yolo_daya_tpu_torch.train import optimizer as port_opt
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, TrainState, bucket_gt
from tests.test_data import make_dataset
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

NC = 4
IMGSZ = (64, 64)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _close(got, want, rtol, what="", atol=1e-12):
    """max |got - want| <= rtol * max |want| + atol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rtol * scale + atol, f"{what}: max abs err {err:.3e} vs scale {scale:.3e}"


# ---------------------------------------------------------------- BatchNorm


def test_batchnorm_train_mode_matches_flax():
    """Batch mean and biased variance for the output, the running statistics
    moved 0.03 toward them (flax momentum 0.97), and the gradients."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (4, 5, 6, 8)).astype(np.float32)  # NHWC
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    scale, bias = (rng.uniform(0.5, 1.5, 8).astype(np.float32),
                   rng.uniform(-0.5, 0.5, 8).astype(np.float32))
    mean, var = (rng.uniform(-0.3, 0.3, 8).astype(np.float32),
                 rng.uniform(0.5, 1.5, 8).astype(np.float32))
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)

    def f(x, scale, bias):
        y, mutated = mod.apply({"params": {"scale": scale, "bias": bias},
                                "batch_stats": {"mean": mean, "var": var}},
                               x, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mutated["batch_stats"])

    (_, (jy, jstats)), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        x, scale, bias)

    bn = BatchNorm(8)
    bn.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(mean),
                        "running_var": _t(var)})
    bn.train()
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    (y * _t(w).permute(0, 3, 1, 2)).sum().backward()
    # f32; the two reduce the statistics in other orders
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jstats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jstats["var"]), atol=1e-6)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), jgrads[0], 1e-5, "d x")
    _close(bn.weight.grad.numpy(), jgrads[1], 1e-5, "d scale")
    _close(bn.bias.grad.numpy(), jgrads[2], 1e-5, "d bias")


def test_model_train_and_eval_switch_batchnorm():
    model = build_yolo11("n", nc=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 3, 32, 32)).astype(np.float32))
    bn = model.layer(0).bn
    before = bn.running_mean.clone()
    with torch.no_grad():
        model.eval()(x)
        assert torch.equal(bn.running_mean, before)  # eval: running statistics only
        model.train()(x)
    assert not torch.equal(bn.running_mean, before)  # train: batch statistics, updated


# ---------------------------------------------------------------- boxes


def _random_boxes(rng, shape, lo=0.0, hi=60.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(0.5, 30.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_bbox_ciou_and_grad_match_jax():
    rng = np.random.default_rng(2)
    b1, b2 = _random_boxes(rng, (64,)), _random_boxes(rng, (64,))
    b2[:8] = b1[:8] + rng.uniform(-0.5, 0.5, (8, 4)).astype(np.float32)  # near-perfect overlap
    w = rng.normal(0, 1, 64).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: jnp.sum(jax_boxes.bbox_ciou(a, b2) * w))(b1)
    got = _t(b1).requires_grad_()
    ciou = port_boxes.bbox_ciou(got, _t(b2))
    (ciou * _t(w)).sum().backward()
    np.testing.assert_allclose(ciou.detach().numpy(), np.asarray(jax_boxes.bbox_ciou(b1, b2)),
                               rtol=1e-5, atol=1e-6)
    _close(got.grad.numpy(), jg, 1e-5, "d ciou")  # alpha gets no gradient on either side


def test_bbox_ciou_bf16_matches_jax():
    """bf16 boxes, the aspect term in f32: both round op by op."""
    rng = np.random.default_rng(3)
    b1, b2 = _random_boxes(rng, (256,)), _random_boxes(rng, (256,))
    want = np.asarray(jax_boxes.bbox_ciou(jnp.asarray(b1, jnp.bfloat16),
                                          jnp.asarray(b2, jnp.bfloat16)), np.float32)
    got = port_boxes.bbox_ciou(_t(b1).bfloat16(), _t(b2).bfloat16())
    assert got.dtype == torch.bfloat16
    # a bf16 step of the result at most where XLA keeps more precision
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(4)
    boxes = _random_boxes(rng, (2, 30), -10.0, 30.0) / 8
    anchors = rng.uniform(0, 8, (30, 2)).astype(np.float32)
    want = jax_boxes.bbox2dist(jnp.asarray(boxes), jnp.asarray(anchors)[None], 16)
    got = port_boxes.bbox2dist(_t(boxes), _t(anchors)[None], 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.max()) <= 16 - 1 - 0.01 + 1e-6 and float(got.min()) >= 0


# ---------------------------------------------------------------- assigner


def _anchor_px():
    pts, strides = port_boxes.make_anchors(IMGSZ)
    return pts * strides


def test_select_candidates_in_gts():
    gt = torch.tensor([[[0, 0, 16, 16]], [[0, 0, 0, 0]]], dtype=torch.float32)
    mask = port_loss.select_candidates_in_gts(_anchor_px(), gt)
    # image 0: the 4 stride-8 anchors inside [0,16]^2 (+ the stride-16 anchor at (8,8))
    assert int(mask[0].sum()) == 5
    assert int(mask[1].sum()) == 0


def test_task_aligned_assign_prefers_matching_anchor():
    anchor_px = _anchor_px()
    a = anchor_px.shape[0]
    pd_boxes = torch.tensor([[30.0, 30.0, 34.0, 34.0]]).repeat(a, 1)[None]
    target_anchor = 9  # grid (1,1) at stride 8 -> centre (12,12)
    pd_boxes[0, target_anchor] = torch.tensor([8.0, 8.0, 16.0, 16.0])
    pd_scores = torch.full((1, a, NC), 0.01)
    pd_scores[0, target_anchor, 2] = 0.9
    gt_box = torch.tensor([[[8.0, 8.0, 16.0, 16.0], [0, 0, 0, 0]]])
    tb, ts, fg, _ = port_loss.task_aligned_assign(
        pd_scores, pd_boxes, anchor_px, torch.tensor([[2, 0]]), gt_box,
        torch.tensor([[True, False]]), nc=NC)
    assert bool(fg[0, target_anchor])
    np.testing.assert_allclose(tb[0, target_anchor].numpy(), [8, 8, 16, 16])
    # the best-aligned anchor's normalised score is its overlap, ~1
    assert float(ts[0, target_anchor, 2]) == pytest.approx(1.0, abs=1e-3)


def _tal_anchors(stop):
    xs = np.arange(8, stop, 16, dtype=np.float32)
    return _t(np.stack(np.meshgrid(xs, xs, indexing="xy"), -1).reshape(-1, 2))


def test_tal_in_box_candidates_and_conflict_resolution():
    """tests/test_parity_fixtures.py's constructed scene: 16 stride-16
    anchors, GT A over [0,32)^2, GT B over [16,64)^2; anchor (24,24) is in
    both and predicts B's box, so the conflict goes to B."""
    gt_boxes = torch.tensor([[[0, 0, 32, 32], [16, 16, 64, 64]]], dtype=torch.float32)
    inside_a_only = np.array([1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], bool)
    pd_boxes = np.where(inside_a_only[:, None], np.array([[0, 0, 32, 32]], np.float32),
                        np.array([[16, 16, 64, 64]], np.float32))
    tb, ts, fg, tgt = port_loss.task_aligned_assign(
        torch.full((1, 16, 2), 0.5), _t(pd_boxes)[None], _tal_anchors(64),
        torch.tensor([[0, 1]]), gt_boxes, torch.tensor([[True, True]]), nc=2, topk=10)
    inside_any = np.array([1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1], bool)
    np.testing.assert_array_equal(fg[0].numpy(), inside_any)
    tgt = tgt[0].numpy()
    assert tgt[5] == 1
    assert tgt[0] == 0 and tgt[1] == 0 and tgt[4] == 0
    assert tgt[10] == 1 and tgt[15] == 1
    np.testing.assert_allclose(tb[0, 0].numpy(), [0, 0, 32, 32])
    np.testing.assert_allclose(tb[0, 15].numpy(), [16, 16, 64, 64])
    ts = ts[0].numpy()
    assert ts[0, 0] == pytest.approx(1.0, abs=2e-2)  # bf16 ranking tolerance
    assert ts[0, 1] == 0.0
    assert ts[15, 1] == pytest.approx(1.0, abs=2e-2)
    assert ts[2].sum() == 0.0


def test_tal_topk_limits_candidates():
    """25 anchors inside one GT with topk=3: the 3 highest scores win (the
    score levels differ by more than a bf16 step after the square root)."""
    scores = np.random.default_rng(0).permutation(np.linspace(0.05, 0.95, 25)).astype(np.float32)
    pd_boxes = np.tile(np.array([[0, 0, 80, 80]], np.float32), (25, 1))
    _, _, fg, _ = port_loss.task_aligned_assign(
        _t(scores)[None, :, None], _t(pd_boxes)[None], _tal_anchors(80),
        torch.tensor([[0]]), torch.tensor([[[0, 0, 80, 80]]], dtype=torch.float32),
        torch.tensor([[True]]), nc=1, topk=3)
    assert int(fg.sum()) == 3
    assert set(np.flatnonzero(fg[0].numpy()).tolist()) == set(np.argsort(-scores)[:3].tolist())


def test_assigner_matches_jax():
    """Random scores and boxes on the 64 px anchors, 3 GTs an image with a
    padded one. fg_mask and the assigned GT must be identical; this seed
    leaves no near-tie in the bf16 metric."""
    rng = np.random.default_rng(6)
    pts, strides = jax_boxes.make_anchors(IMGSZ)
    anchor_px = np.asarray(pts * strides)
    a = len(anchor_px)
    wh = rng.uniform(8, 40, (2, a, 2)).astype(np.float32)
    pd_boxes = np.concatenate([anchor_px - wh / 2, anchor_px + wh / 2], -1).astype(np.float32)
    pd_scores = rng.uniform(0.01, 0.9, (2, a, NC)).astype(np.float32)
    gt = np.array([[[4, 4, 40, 36], [30, 20, 62, 60], [0, 40, 24, 63], [0, 0, 0, 0]],
                   [[10, 10, 50, 50], [2, 30, 30, 62], [36, 0, 63, 28], [0, 0, 0, 0]]],
                  np.float32)
    labels = np.array([[0, 1, 3, 0], [2, 2, 1, 0]])
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
    jtb, jts, jfg, jidx = jax_loss.task_aligned_assign(
        jnp.asarray(pd_scores), jnp.asarray(pd_boxes), jnp.asarray(anchor_px),
        jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask), nc=NC)
    tb, ts, fg, idx = port_loss.task_aligned_assign(
        _t(pd_scores), _t(pd_boxes), _t(anchor_px), _t(labels), _t(gt), _t(mask), nc=NC)
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert 10 < int(fg.sum()) < a * 2
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    # target scores come out of the bf16 metric: equal metrics give equal
    # scores, the f32 product with the one-hot aside
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- DFL, BCE


def test_dfl_closed_form():
    """target 2.3 -> bins (2, 3) weighted (0.7, 0.3), mean over 4 sides."""
    logits = np.zeros((1, 4, 16), np.float32)
    logits[0, :, 2], logits[0, :, 3] = 2.0, 1.0
    logp = np.log(np.exp(logits[0, 0]) / np.exp(logits[0, 0]).sum())
    got = port_loss._dfl_loss(_t(logits), torch.full((1, 4), 2.3))
    assert float(got[0]) == pytest.approx(float(-(0.7 * logp[2] + 0.3 * logp[3])), rel=1e-5)


def test_dfl_integer_target_single_bin():
    logits = np.zeros((1, 4, 16), np.float32)
    logits[0, :, 5] = 3.0
    p = np.exp(logits[0, 0]) / np.exp(logits[0, 0]).sum()
    got = port_loss._dfl_loss(_t(logits), torch.full((1, 4), 5.0))
    assert float(got[0]) == pytest.approx(float(-np.log(p[5])), rel=1e-5)


def test_dfl_edge_bin_clamps():
    """target at REG_MAX-1: the right bin clamps to REG_MAX-1 with weight 0."""
    logits = np.random.default_rng(0).normal(size=(1, 4, 16)).astype(np.float32)
    got = port_loss._dfl_loss(_t(logits), torch.full((1, 4), 15.0))
    logp = logits[0] - np.log(np.exp(logits[0]).sum(-1, keepdims=True))
    assert float(got[0]) == pytest.approx(float(-logp[:, 15].mean()), rel=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dfl_and_bce_match_jax(dtype):
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, (3, 5, 4, 16)).astype(np.float32)
    target = rng.uniform(0, 15, (3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port_loss._dfl_loss(_t(logits), _t(target)).numpy(),
        np.asarray(jax_loss._dfl_loss(jnp.asarray(logits), jnp.asarray(target))), rtol=1e-5)
    x = rng.normal(0, 4, (3, 50)).astype(np.float32)
    t = rng.uniform(0, 1, (3, 50)).astype(np.float32)
    want = np.asarray(jax_loss._bce_logits(jnp.asarray(x, dtype), jnp.asarray(t)), np.float32)
    got = port_loss._bce_logits(_t(x).to(getattr(torch, dtype)), _t(t))
    assert got.dtype == getattr(torch, dtype)  # the logits' dtype
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=1e-6 if dtype == "float32" else 1e-2, atol=1e-6)


# ---------------------------------------------------------------- detection loss


def _fake_levels(b=2, nc=NC, key=0):
    """Per-level NHWC head outputs (tests/test_loss.py's)."""
    rng = np.random.default_rng(key)
    box = [rng.normal(0, 0.5, (b, s, s, 64)).astype(np.float32) for s in (8, 4, 2)]
    cls = [rng.normal(-4, 0.5, (b, s, s, nc)).astype(np.float32) for s in (8, 4, 2)]
    return box, cls


def _nchw(levels, requires_grad=False):
    return [_t(x).permute(0, 3, 1, 2).requires_grad_(requires_grad) for x in levels]


GT_LABELS = np.array([[1, 2], [0, 0]])
GT_BOXES = np.array([[[4, 4, 30, 30], [32, 32, 60, 60]], [[10, 10, 50, 50], [0, 0, 0, 0]]],
                    np.float32)
GT_MASK = np.array([[True, True], [True, False]])


def _port_loss(box, cls, labels=GT_LABELS, boxes=GT_BOXES, mask=GT_MASK, cfg=None):
    return port_loss.detection_loss(box, cls, _t(labels), _t(boxes), _t(mask), IMGSZ,
                                    cfg or port_loss.LossConfig(nc=NC))


def test_detection_loss_finite_and_grads():
    box, cls = _nchw(_fake_levels()[0], True), _nchw(_fake_levels()[1], True)
    total, parts = _port_loss(box, cls)
    total.backward()
    assert np.isfinite(float(total.detach())) and float(parts["num_fg"]) > 0
    assert all(torch.isfinite(x.grad).all() for x in box + cls)
    assert any(float(x.grad.abs().sum()) > 0 for x in box)
    assert any(float(x.grad.abs().sum()) > 0 for x in cls)


def test_detection_loss_empty_image():
    box, cls = _nchw(_fake_levels()[0]), _nchw(_fake_levels()[1])
    total, parts = _port_loss(box, cls, np.zeros((2, 2), np.int64),
                              np.zeros((2, 2, 4), np.float32), np.zeros((2, 2), bool))
    assert np.isfinite(float(total))
    assert float(parts["num_fg"]) == 0 and float(parts["box_loss"]) == 0


def test_loss_batch_scale_semantics():
    """batch_scale=True multiplies the batch-invariant total by the batch."""
    box, cls = _nchw(_fake_levels()[0]), _nchw(_fake_levels()[1])
    plain = port_loss.LossConfig(nc=NC)
    scaled = port_loss.LossConfig(nc=NC, batch_scale=True)
    base = float(_port_loss(box, cls, cfg=plain)[0])
    assert float(_port_loss(box, cls, cfg=scaled)[0]) == pytest.approx(base * 2, rel=1e-6)
    dup = lambda x: np.concatenate([x, x])  # noqa: E731
    box2 = [torch.cat([x, x]) for x in box]
    cls2 = [torch.cat([x, x]) for x in cls]
    args = (dup(GT_LABELS), dup(GT_BOXES), dup(GT_MASK))
    assert float(_port_loss(box2, cls2, *args, cfg=plain)[0]) == pytest.approx(base, rel=1e-5)
    assert float(_port_loss(box2, cls2, *args, cfg=scaled)[0]) == pytest.approx(base * 4,
                                                                                 rel=1e-5)


def test_detection_loss_and_grads_match_jax():
    box, cls = _fake_levels()

    def f(levels):
        return jax_loss.detection_loss(levels[0], levels[1], jnp.asarray(GT_LABELS),
                                       jnp.asarray(GT_BOXES), jnp.asarray(GT_MASK), IMGSZ,
                                       jax_loss.LossConfig(nc=NC))

    (jtotal, jparts), jgrads = jax.value_and_grad(f, has_aux=True)(
        ([jnp.asarray(x) for x in box], [jnp.asarray(x) for x in cls]))
    tbox, tcls = _nchw(box, True), _nchw(cls, True)
    total, parts = _port_loss(tbox, tcls)
    total.backward()
    assert float(parts["num_fg"]) == float(jparts["num_fg"]) > 0
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-5), k
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    for t, j in zip(tbox + tcls, jgrads[0] + jgrads[1]):
        _close(t.grad.permute(0, 2, 3, 1).numpy(), j, 1e-4, "d head")


# ---------------------------------------------------------------- optimizer


SCHEDULES = [
    dict(lr0=0.01, lrf=0.1, warmup_epochs=1, epochs=10, steps_per_epoch=10),
    dict(lr0=0.02, lrf=0.01, warmup_epochs=2.5, epochs=6, steps_per_epoch=4, cos_lr=True),
    dict(lr0=0.01, lrf=0.01, warmup_epochs=0, epochs=5, steps_per_epoch=3),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_match_jax(kw):
    cfg_j, cfg_p = jax_opt.OptimizerConfig(**kw), port_opt.OptimizerConfig(**kw)
    steps = np.arange(kw["epochs"] * kw["steps_per_epoch"] + 3)
    for start in (0.0, cfg_p.warmup_bias_lr):
        want = jax_opt.lr_schedule(cfg_j, warmup_start=start, xp=np)
        got = port_opt.lr_schedule(cfg_p, warmup_start=start)
        np.testing.assert_allclose([got(int(s)) for s in steps],
                                   [float(want(s)) for s in steps], rtol=1e-6, atol=1e-9)
    want = jax_opt.momentum_schedule(cfg_j)
    got = port_opt.momentum_schedule(cfg_p)
    np.testing.assert_allclose([got(int(s)) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6)


class _Tiny(nn.Module):
    """A conv with bias, a BatchNorm and a 1x1 head: every parameter group."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 8, 3)
        self.bn = BatchNorm(8)
        self.head = nn.Conv2d(8, 2, 1, bias=False)


def test_param_groups():
    groups = port_opt.param_groups(_Tiny())
    assert [p.shape for p in groups["decay"]] == [(8, 4, 3, 3), (2, 8, 1, 1)]
    assert [p.shape for p in groups["no_decay"]] == [(8,)]   # BN weight
    assert [p.shape for p in groups["bias"]] == [(8,), (8,)]  # conv bias, BN bias


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW"])
def test_optimizer_steps_match_optax(name):
    """Three updates with the same gradients through the JAX package's optax
    chain and the port's torch.optim groups (the first in warmup, where the
    main group's lr is 0 and the bias group's 0.1)."""
    rng = np.random.default_rng(8)
    model = _Tiny()
    params = {"conv": {"kernel": rng.normal(0, 1, (3, 3, 4, 8)), "bias": rng.normal(0, 1, 8)},
              "bn": {"scale": rng.uniform(0.5, 1.5, 8), "bias": rng.normal(0, 1, 8)},
              "head": {"kernel": rng.normal(0, 1, (1, 1, 8, 2))}}
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    port_of = {("conv", "kernel"): model.conv.weight, ("conv", "bias"): model.conv.bias,
               ("bn", "scale"): model.bn.weight, ("bn", "bias"): model.bn.bias,
               ("head", "kernel"): model.head.weight}

    def to_port(a):
        a = np.asarray(a, np.float32)
        return _t(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)

    with torch.no_grad():
        for (m, k), p in port_of.items():
            p.copy_(to_port(params[m][k]))
    kw = dict(name=name, lr0=0.01, warmup_epochs=1, epochs=3, steps_per_epoch=2)
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**kw), params)
    opt_state = tx.init(params)
    opt = port_opt.Optimizer(port_opt.OptimizerConfig(**kw), model)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(0, 1, a.shape), jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for (m, k), p in port_of.items():
            p.grad = to_port(grads[m][k])
        hyper = torch.zeros(port_opt.N_HYPER)
        for col, v in opt.hyper_row(step).items():
            hyper[col] = v
        opt.step(hyper)
        for (m, k), p in port_of.items():
            np.testing.assert_allclose(p.detach().numpy(), to_port(params[m][k]).numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} {m}.{k} {step}")


@pytest.mark.parametrize("step", [1, 2, 1000])
def test_ema_update_matches_jax(step):
    rng = np.random.default_rng(step)
    ema, new = rng.normal(0, 1, (2, 5, 3)).astype(np.float32)
    want = jax_opt.ema_update({"a": jnp.asarray(ema)}, {"a": jnp.asarray(new)}, step)["a"]
    got = [_t(ema.copy())]
    port_opt.ema_update(got, [_t(new)], step)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_bucket_gt_matches_jax():
    mask = np.zeros((3, 16), bool)
    mask[0, :5] = mask[2, :2] = True
    boxes, classes = np.ones((3, 16, 4), np.float32), np.zeros((3, 16), np.int32)
    for got, want in zip(bucket_gt(boxes, classes, mask, 16),
                         jax_bucket_gt(boxes, classes, mask, 16)):
        assert got.shape == want.shape == (3, 8) + want.shape[2:]
    got = bucket_gt(_t(boxes), _t(classes), _t(mask), 16)  # CPU tensors too
    assert got[2].shape == (3, 8)


# ---------------------------------------------------------------- the whole step
#
# Two things set the tolerances here; both are in the reference, not the port.
# - flax computes a batch variance as E[x^2] - E[x]^2 in f32. That rounding
#   alone moves JAX's second update by up to 37% in some tensors (9.cv1), where
#   the port and flax's two-pass variance agree. The fixture therefore runs
#   the JAX Trainer with flax's two-pass variance: the same function, computed
#   more exactly.
# - Under jit, XLA fuses the assigner's bf16 metric ops and keeps f32 across
#   them, where the port (like eager JAX) rounds each op: on the same head
#   outputs the port's assignment equals eager JAX's exactly, and jitted JAX's
#   target scores differ from it by a bf16 step in a few anchors. That moves
#   some head gradients by ~2%.
# The lr is small and has no warmup (whose bias group starts at 0.1), so that
# the two steps stay near linear; warmup is held against optax above.

STEP_IMGSZ, STEP_NC, STEP_BATCH, STEPS = 128, 2, 4, 2
STEP_LR0 = 1e-3
GRAD_RTOL = 5e-2    # of each gradient's largest entry (the jitted bf16 metric)
GRAD_ATOL = 1e-6    # gradients that are ~0 (e.g. a BN bias that the next BN cancels)
DELTA_RTOL = 1e-2   # of each update's largest entry
STATS_RTOL = 1e-4
ULPS = 4 * np.finfo(np.float32).eps  # a new - old difference is exact to ~1 ulp of the values


def _fixed_batch():
    """Four images of noise with one to three 12-15 px boxes each, one a
    quadrant, so that no GT has more candidate anchors than the top-k and
    no anchor is claimed twice: the assignment then does not hang on
    near-ties of the bf16 metric. u8 images and GT padded to 4."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (STEP_BATCH, STEP_IMGSZ, STEP_IMGSZ, 3)).astype(np.uint8)
    boxes = np.zeros((STEP_BATCH, 4, 4), np.float32)
    classes = np.zeros((STEP_BATCH, 4), np.int32)
    mask = np.zeros((STEP_BATCH, 4), bool)
    half = STEP_IMGSZ // 2
    for i in range(STEP_BATCH):
        quadrants = rng.permutation(4)[:int(rng.integers(1, 4))]
        for j, q in enumerate(quadrants):
            w, h = (int(v) for v in rng.integers(12, 16, 2))
            x = half * (q % 2) + int(rng.integers(2, half - 2 - w))
            y = half * (q // 2) + int(rng.integers(2, half - 2 - h))
            c = int(rng.integers(0, STEP_NC))
            images[i, y:y + h, x:x + w] = (230, 30, 30) if c == 0 else (30, 230, 30)
            boxes[i, j], classes[i, j], mask[i, j] = (x, y, x + w, y + h), c, True
    return images, boxes, classes, mask


def _small_box_head(params):
    """Box-head biases that favour DFL bin 1, so that random-init boxes are
    ~2.5 grid units wide (20 px at stride 8) and overlap the small GTs."""
    params = jax.tree_util.tree_map(lambda a: a, params)
    for i in range(3):
        bias = np.zeros((4, 16), np.float32)
        bias[:, 1] = 6.0
        params["detect"][f"box{i}_2"]["bias"] = jnp.asarray(bias.reshape(-1))
    return params


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer (imgsz 128, batch 4, f32, nesterov SGD) on the fixed
    batch: two train steps, and jax.grad of the step's own loss at the
    initial state, with flax's two-pass batch variance. Built once: its CPU
    compile is the slow part of this file."""
    from flax.linen import normalization
    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from deal_yolo_daya_tpu.train.trainer import Trainer, scale_stem_kernel

    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    tmp = tmp_path_factory.mktemp("port_train")
    data_yaml = make_dataset(tmp, n_train=8, n_val=4, imgsz=STEP_IMGSZ, nc=STEP_NC)
    trainer = Trainer(JaxTrainConfig(
        model="yolo11n", data=str(data_yaml), epochs=3, imgsz=STEP_IMGSZ, batch=STEP_BATCH,
        amp=False, close_mosaic=0, project=str(tmp / "runs"), name="t", seed=0, device="1",
        max_boxes=16, lr0=STEP_LR0, warmup_epochs=0, workers=1, device_augment=False))
    assert trainer.cfg.fold_input_div and trainer.cfg.optimizer == "auto"  # nesterov SGD
    images, boxes, classes, mask = _fixed_batch()
    params = _small_box_head(trainer.state.params)
    state = trainer.state._replace(params=params,
                                   ema_params=jax.tree_util.tree_map(jnp.copy, params))

    def loss_fn(params):
        p = scale_stem_kernel(params, 1.0 / 255.0)
        (box, cls), _ = trainer.model.apply(
            {"params": p, "batch_stats": state.batch_stats}, jnp.asarray(images, jnp.float32),
            train=True, mutable=["batch_stats"])
        total, _ = jax_loss.detection_loss(box, cls, classes, boxes, mask,
                                           (STEP_IMGSZ, STEP_IMGSZ), trainer.loss_cfg)
        return total, (box, cls)

    normalization._compute_stats = two_pass_stats  # while the programs are traced
    try:
        (_, (box0, cls0)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            state.params)
        record = {"steps_per_epoch": len(trainer.train_loader),
                  "initial": {"params": _np_tree(state.params),
                              "batch_stats": _np_tree(state.batch_stats)},
                  "grads": _np_tree(grads), "head": (_np_tree(box0), _np_tree(cls0)),
                  "steps": []}
        acc = trainer.zero_loss_acc()
        for _ in range(STEPS):
            state, _, acc = trainer.train_step(state, acc, images, boxes, classes, mask)
            record["steps"].append({"params": _np_tree(state.params),
                                    "batch_stats": _np_tree(state.batch_stats),
                                    "ema": _np_tree(state.ema_params),
                                    "acc": {k: float(v) for k, v in acc.items()}})
    finally:
        normalization._compute_stats = compute_stats
    return record


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's TrainState on the same weights, config and batch."""
    images, boxes, classes, mask = (_t(a) for a in _fixed_batch())
    cfg = TrainConfig(model="yolo11n", epochs=3, imgsz=STEP_IMGSZ, amp=False, seed=0,
                      max_boxes=16, lr0=STEP_LR0, warmup_epochs=0)
    state = TrainState(cfg, nc=STEP_NC, steps_per_epoch=jax_run["steps_per_epoch"],
                       device="cpu", state_dict=state_dict_from_jax(jax_run["initial"]))
    with torch.no_grad():
        head = copy.deepcopy(state).forward(images)
    record = {"head": head, "initial": {k: v.clone() for k, v in state.model.state_dict().items()},
              "steps": []}
    for i in range(STEPS):
        state.step(images, boxes, classes, mask)
        if i == 0:
            record["grads"] = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        record["steps"].append({
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema_state_dict().items()},
            "acc": {k: float(v) for k, v in state.loss_acc.items()}})
    return record


def _jax_assign(box_levels, cls_levels):
    """Eager JAX assignment from NHWC head outputs, as detection_loss runs it."""
    box, cls = jax_decode.flatten_levels([jnp.asarray(x) for x in box_levels],
                                         [jnp.asarray(x) for x in cls_levels])
    pts, strides = jax_boxes.make_anchors((STEP_IMGSZ, STEP_IMGSZ))
    pd_px = jax_boxes.dist2bbox(jax_decode.dfl_expectation(box), pts[None]) * strides[None]
    _, boxes, classes, mask = _fixed_batch()
    return [np.asarray(a) for a in jax_loss.task_aligned_assign(
        jax.nn.sigmoid(cls), pd_px, pts * strides, jnp.asarray(classes), jnp.asarray(boxes),
        jnp.asarray(mask), nc=STEP_NC)]


def _port_assign(box_levels, cls_levels):
    """The port's assignment from NCHW head outputs."""
    box, cls = port_decode.flatten_levels(box_levels, cls_levels)
    pts, strides = port_boxes.make_anchors((STEP_IMGSZ, STEP_IMGSZ))
    pd_px = port_boxes.dist2bbox(port_decode.dfl_expectation(box), pts[None]) * strides[None]
    _, boxes, classes, mask = _fixed_batch()
    return [a.numpy() for a in port_loss.task_aligned_assign(
        torch.sigmoid(cls), pd_px, pts * strides, _t(classes), _t(boxes), _t(mask), nc=STEP_NC)]


def test_train_step_assignment_matches_jax(jax_run, port_run):
    """The same initial weights give the same head outputs (f32, to 1e-4 of
    each level's largest value); on each side's own outputs the assigner
    gives the identical fg_mask and assigned GT; and on JAX's outputs the
    port's assignment equals eager JAX's exactly, target scores included."""
    jbox, jcls = jax_run["head"]
    tbox, tcls = port_run["head"]
    for j, t in zip(jbox + jcls, tbox + tcls):
        _close(t.permute(0, 2, 3, 1).numpy(), j, 1e-4, "head output")
    _, _, jfg, jidx = _jax_assign(jbox, jcls)
    _, _, fg, idx = _port_assign(tbox, tcls)
    np.testing.assert_array_equal(fg, jfg)
    np.testing.assert_array_equal(idx[fg], jidx[jfg])
    assert int(fg.sum()) > 0
    want = _jax_assign(jbox, jcls)
    got = _port_assign([_t(x).permute(0, 3, 1, 2) for x in jbox],
                       [_t(x).permute(0, 3, 1, 2) for x in jcls])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_loss_parts_match_jax(jax_run, port_run, step):
    """Loss parts summed over the steps so far, to 1e-4; the foreground
    count exactly."""
    want, got = jax_run["steps"][step]["acc"], port_run["steps"][step]["acc"]
    assert got["num_fg"] == want["num_fg"] > 0
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_train_step_gradients_match_jax(jax_run, port_run):
    """Every parameter's gradient at the first step against jax.grad of the
    same loss: within GRAD_RTOL of its largest entry, or GRAD_ATOL where a
    tensor's gradient is ~0."""
    want = state_dict_from_jax({"params": jax_run["grads"]})
    got = port_run["grads"]
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        _close(g.numpy(), want[name].numpy(), GRAD_RTOL, name, atol=GRAD_ATOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_updates_match_jax(jax_run, port_run, step):
    """Parameter deltas (new - old, not the parameters), BN running
    statistics and the EMA's move from the initial weights, after each
    step."""
    before_j = jax_run["initial"] if step == 0 else jax_run["steps"][step - 1]
    after_j = jax_run["steps"][step]
    before_p = port_run["initial"] if step == 0 else port_run["steps"][step - 1]["state"]
    after_p = port_run["steps"][step]["state"]
    old = state_dict_from_jax({"params": before_j["params"]})
    new = state_dict_from_jax({"params": after_j["params"]})
    init = state_dict_from_jax({"params": jax_run["initial"]["params"]})
    ema = state_dict_from_jax({"params": after_j["ema"]})
    moved = set()
    for name in new:
        want = (new[name] - old[name]).numpy()
        if np.abs(want).max() > 0:
            moved.add(name)
        # f32 resolution of the values, and a ~0 gradient through nesterov SGD
        floor = ULPS * float(np.abs(old[name].numpy()).max()) + 2 * STEP_LR0 * GRAD_ATOL
        got = (after_p[name] - before_p[name]).numpy()
        _close(got, want, DELTA_RTOL, f"delta {name} step {step}", atol=floor)
        got = (port_run["steps"][step]["ema"][name] - port_run["initial"][name]).numpy()
        _close(got, (ema[name] - init[name]).numpy(), DELTA_RTOL, f"ema {name} step {step}",
               atol=floor)
    # every parameter group moves: conv kernels, BN weights, biases
    assert {n.endswith("conv.weight") for n in moved} == {True, False}
    assert any(n.endswith("bn.weight") for n in moved) and any(n.endswith("bias") for n in moved)
    stats = state_dict_from_jax({"batch_stats": after_j["batch_stats"]})
    for name, want in stats.items():
        np.testing.assert_allclose(after_p[name].numpy(), want.numpy(), rtol=STATS_RTOL,
                                   atol=STATS_RTOL, err_msg=name)

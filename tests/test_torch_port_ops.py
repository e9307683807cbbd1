"""The port's box geometry, decode, NMS and letterbox against the JAX
package and against a sequential greedy NMS, with numpy-made inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deal_yolo_daya_tpu.ops import boxes as jax_boxes
from deal_yolo_daya_tpu.ops.decode import decode_predictions as jax_decode
from deal_yolo_daya_tpu.ops.letterbox import letterbox_numpy as jax_letterbox_numpy
from deal_yolo_daya_tpu.ops.letterbox import letterbox_params as jax_letterbox_params
from deal_yolo_daya_tpu.ops.nms import batched_nms as jax_batched_nms
from deal_yolo_daya_tpu_torch.ops import boxes
from deal_yolo_daya_tpu_torch.ops.decode import decode_predictions
from deal_yolo_daya_tpu_torch.ops.letterbox import letterbox_numpy, letterbox_params
from deal_yolo_daya_tpu_torch.ops.nms import batched_nms


def _random_boxes(rng, shape, lo=0.0, hi=200.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(2.0, 60.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_functions_match_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, (20,)), _random_boxes(rng, (30,))
    np.testing.assert_array_equal(
        boxes.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_iou_matrix(jnp.asarray(a), jnp.asarray(b))))
    for name in ("xywh2xyxy", "xyxy2xywh"):
        np.testing.assert_allclose(getattr(boxes, name)(torch.from_numpy(a)).numpy(),
                                   np.asarray(getattr(jax_boxes, name)(jnp.asarray(a))),
                                   rtol=1e-6)
    pts, strides = boxes.make_anchors((64, 96))
    jpts, jstrides = jax_boxes.make_anchors((64, 96))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(jstrides))
    dist = rng.uniform(0, 15, (len(pts), 4)).astype(np.float32)
    for xywh in (False, True):
        np.testing.assert_allclose(
            boxes.dist2bbox(torch.from_numpy(dist), pts, xywh=xywh).numpy(),
            np.asarray(jax_boxes.dist2bbox(jnp.asarray(dist), jpts, xywh=xywh)), rtol=1e-6)


def test_decode_matches_jax_anchor_order():
    # NCHW levels in the port, NHWC in JAX: the anchor order must agree
    rng = np.random.default_rng(1)
    imgsz, nc = (64, 96), 5
    box_levels, cls_levels = [], []
    for s in (8, 16, 32):
        h, w = imgsz[0] // s, imgsz[1] // s
        box_levels.append(rng.normal(0, 2, (2, h, w, 64)).astype(np.float32))
        cls_levels.append(rng.normal(0, 2, (2, h, w, nc)).astype(np.float32))
    jb, js = jax_decode([jnp.asarray(x) for x in box_levels],
                        [jnp.asarray(x) for x in cls_levels], imgsz)
    to_nchw = lambda xs: [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]  # noqa: E731
    tb, ts = decode_predictions(to_nchw(box_levels), to_nchw(cls_levels), imgsz)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)


def _greedy_nms_reference(boxes_, scores, iou_thr):
    """Sequential greedy NMS (strict > comparison), as
    tests/test_parity_fixtures.py holds the JAX package to."""
    order = np.argsort(-scores, kind="stable")
    keep, suppressed = [], np.zeros(len(boxes_), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes_[i, 0], boxes_[:, 0])
        y1 = np.maximum(boxes_[i, 1], boxes_[:, 1])
        x2 = np.minimum(boxes_[i, 2], boxes_[:, 2])
        y2 = np.minimum(boxes_[i, 3], boxes_[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area_i = (boxes_[i, 2] - boxes_[i, 0]) * (boxes_[i, 3] - boxes_[i, 1])
        areas = (boxes_[:, 2] - boxes_[:, 0]) * (boxes_[:, 3] - boxes_[:, 1])
        suppressed |= inter / (area_i + areas - inter + 1e-9) > iou_thr
        suppressed[i] = True
    return keep


@pytest.mark.parametrize("iou_thr", [0.45, 0.7])
def test_batched_nms_matches_sequential_greedy(iou_thr):
    rng = np.random.default_rng(3)
    n, nc = 400, 8
    centers = rng.uniform(50, 450, (n, 2))
    wh = rng.uniform(20, 120, (n, 2))
    bx = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    cls = rng.integers(0, nc, n)
    conf = rng.uniform(0.3, 1.0, n).astype(np.float32)
    scores = np.zeros((n, nc), np.float32)
    scores[np.arange(n), cls] = conf
    ob, osc, ocls, nd = batched_nms(torch.from_numpy(bx)[None], torch.from_numpy(scores)[None],
                                    conf_thres=0.25, iou_thres=iou_thr, pre_topk=n, max_det=n)
    nd = int(nd[0])
    got = {(round(float(b[0]), 3), round(float(b[1]), 3), int(c))
           for b, c in zip(ob[0].numpy()[:nd], ocls[0].numpy()[:nd])}
    keep = _greedy_nms_reference(bx + cls[:, None].astype(np.float32) * 7680.0, conf, iou_thr)
    want = {(round(float(bx[i, 0]), 3), round(float(bx[i, 1]), 3), int(cls[i])) for i in keep}
    assert got == want and nd == len(keep)


@pytest.mark.parametrize("agnostic", [False, True])
def test_batched_nms_matches_jax(agnostic):
    # dense scene with score ties (quantized scores) and padding past the
    # candidates (max_det > pre_topk)
    rng = np.random.default_rng(4)
    b, a, nc = 2, 300, 4
    bx = _random_boxes(rng, (b, a))
    scores = (rng.integers(0, 20, (b, a, nc)) / 20.0).astype(np.float32)
    kwargs = dict(conf_thres=0.3, iou_thres=0.5, pre_topk=200, max_det=250,
                  class_agnostic=agnostic)
    want = jax_batched_nms(jnp.asarray(bx), jnp.asarray(scores), **kwargs)
    got = batched_nms(torch.from_numpy(bx), torch.from_numpy(scores), **kwargs)
    assert got[2].dtype == got[3].dtype == torch.int32
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_greedy_cascade():
    # B overlaps A (suppressed); C overlaps B but not A -> greedy keeps C
    bx = torch.tensor([[[0, 0, 10, 10], [4, 0, 14, 10], [8, 0, 18, 10]]], dtype=torch.float32)
    scores = torch.tensor([[[0.9], [0.8], [0.7]]])
    _, osc, ocls, nd = batched_nms(bx, scores, conf_thres=0.1, iou_thres=0.4,
                                   pre_topk=3, max_det=5)
    assert int(nd[0]) == 2
    np.testing.assert_allclose(osc[0].numpy(), [0.9, 0.7, 0, 0, 0], atol=1e-6)
    np.testing.assert_array_equal(ocls[0].numpy(), [0, 0, -1, -1, -1])


@pytest.mark.parametrize("h,w,size", [(480, 640, 640), (100, 37, 64), (64, 64, 64), (30, 50, 96)])
def test_letterbox_matches_jax(h, w, size):
    assert letterbox_params(h, w, size) == jax_letterbox_params(h, w, size)
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # smooth content, as photographs are, plus noise: interpolation
    # rounding shows, not aliasing of pure noise
    img = ((img.astype(np.float32) + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3).astype(np.uint8)
    got, r, pad = letterbox_numpy(img, size)
    want, jr, jpad = jax_letterbox_numpy(img, size)
    assert (r, pad) == (jr, jpad) and got.shape == want.shape and got.dtype == np.uint8
    # torch's and cv2's fixed-point u8 bilinear round apart: within 1 level
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    px, py = pad
    nh, nw = round(h * r), round(w * r)
    assert (got[:py] == 114).all() and (got[py + nh:] == 114).all()
    assert (got[:, :px] == 114).all() and (got[:, px + nw:] == 114).all()


def test_score_reduce_on_logits_differs_from_nms_on_sigmoid_only_at_f32_ties():
    """Pinned behaviour, and the reason score_reduce is not wired into
    batched_nms: NMS reduces sigmoid scores, score_reduce reduces logits.
    Where two logits' f32 sigmoids are equal (both 1.0 above ~16.6, or two
    logits closer than the sigmoid's resolution), NMS takes the lower class,
    as the JAX package's batched_nms does, and score_reduce the larger
    logit. The max score is the same either way; elsewhere the classes
    agree."""
    from deal_yolo_daya_tpu_torch.ops.kernels.score_reduce import score_reduce

    logits = np.full((1, 4, 3), -5.0, np.float32)
    logits[0, 0, :2] = (17.0, 20.0)                 # both sigmoids are 1.0
    logits[0, 1, :2] = (3.0, np.nextafter(np.float32(3.0), np.float32(4.0)))
    logits[0, 2, :2] = (1.0, 2.0)                   # no tie: both agree
    logits[0, 3, 2] = 0.5
    x = torch.from_numpy(logits)
    sig = torch.sigmoid(x)
    assert sig[0, 0, 0] == sig[0, 0, 1] == 1.0 and sig[0, 1, 0] == sig[0, 1, 1]
    boxes_ = torch.tensor([[[0.0, 0, 10, 10], [20, 0, 30, 10], [40, 0, 50, 10], [60, 0, 70, 10]]])
    _, nms_scores, nms_cls, n_det = batched_nms(boxes_, sig, conf_thres=0.1, iou_thres=0.7)
    want_s, want_c = (np.asarray(a) for a in jax_batched_nms(
        jnp.asarray(boxes_.numpy()), jnp.asarray(sig.numpy()), conf_thres=0.1, iou_thres=0.7)[1:3])
    np.testing.assert_array_equal(nms_cls.numpy(), want_c)
    score, cls = score_reduce(x)
    # the boxes do not overlap and the scores fall: NMS keeps the anchor order
    assert int(n_det[0]) == 4 and nms_cls[0, :4].tolist() == [0, 0, 1, 2]
    assert cls[0].tolist() == [1, 1, 1, 2]
    np.testing.assert_array_equal(score[0].numpy(), nms_scores[0, :4].numpy())
    np.testing.assert_array_equal(score[0].numpy(), want_s[0, :4])

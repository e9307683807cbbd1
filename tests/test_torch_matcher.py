"""Validation's matcher on the CPU: ``train/metrics.py::match_predictions``
takes the native (C++) matcher of ``runtime/labelscan.cpp`` first, as the
JAX package's does, and its numpy loop only without the library.

Bars: exact. The native path, the port's numpy loop and the JAX package's
``match_predictions`` (which takes its own native matcher) give equal
(n_pred, 10) matrices on random cases and on IoUs planted exactly at each
threshold in float32, and ``DetMetrics`` gives equal results with and
without the library."""

import numpy as np
import pytest

import deal_yolo_daya_tpu_torch.runtime as rt
from deal_yolo_daya_tpu_torch.train import metrics as M

import jax_native
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def native_library():
    if rt.get_lib() is None:
        pytest.skip("the native library does not build here (no g++)")
    jax_native.loaded()  # the JAX side's matcher too (tests/jax_native.py)


def _numpy_loop(*args):
    """The port's ``match_predictions`` with the library taken away."""
    orig = rt.match_predictions_native
    rt.match_predictions_native = lambda *a, **k: None
    try:
        return M.match_predictions(*args)
    finally:
        rt.match_predictions_native = orig


def _random_case(rng):
    n_pred, n_gt = int(rng.integers(0, 40)), int(rng.integers(0, 12))
    pb = rng.uniform(0, 80, (n_pred, 4)).astype(np.float32)
    pb[:, 2:] += pb[:, :2]
    gb = rng.uniform(0, 80, (n_gt, 4)).astype(np.float32)
    gb[:, 2:] += gb[:, :2]
    for k in range(min(n_pred, n_gt)):  # overlaps, so that matches occur
        pb[k] = gb[k] + rng.normal(0, 3, 4).astype(np.float32)
    return (pb, rng.integers(0, 3, n_pred).astype(np.int32), gb,
            rng.integers(0, 3, n_gt).astype(np.int32))


def _planted_ties():
    """A threshold t each: GT 0 of 100 x 100 px and GT 1 of 100 x (100 t) px
    inside it; predictions 0 and 1 both equal to GT 1 (IoU 1 with it, IoU
    exactly float32(t) with GT 0: h / 100 in float32), so that the greedy
    order decides which takes which; and prediction 2, GT 0's box in
    another class."""
    cases = []
    for t in (50, 55, 60, 65, 70, 75, 80, 85, 90, 95):
        gb = np.array([[0, 0, 100, 100], [0, 0, 100, t]], np.float32)
        pb = np.array([[0, 0, 100, t], [0, 0, 100, t], [0, 0, 100, 100]], np.float32)
        cases.append((pb, np.array([0, 0, 1], np.int32), gb, np.array([0, 0], np.int32)))
    return cases


def _jax_match(*args):
    from deal_yolo_daya_tpu.train import metrics as JM

    return JM.match_predictions(*args)


def test_match_predictions_takes_the_native_path(monkeypatch):
    calls = []
    orig = rt.match_predictions_native

    def counted(*a):
        calls.append(a[-1])
        return orig(*a)

    monkeypatch.setattr(rt, "match_predictions_native", counted)
    got = M.match_predictions(*_planted_ties()[3])
    assert len(calls) == 1 and calls[0].dtype == np.float32
    np.testing.assert_array_equal(calls[0], M.IOU_THRESHOLDS.astype(np.float32))
    assert got.shape == (3, 10) and got.dtype == bool


@pytest.mark.parametrize("seed", range(4))
def test_native_equals_numpy_and_jax_on_random_cases(seed):
    rng = np.random.default_rng(100 + seed)
    for trial in range(20):
        case = _random_case(rng)
        native = rt.match_predictions_native(*case, M.IOU_THRESHOLDS.astype(np.float32))
        np.testing.assert_array_equal(M.match_predictions(*case), native, err_msg=str(trial))
        np.testing.assert_array_equal(_numpy_loop(*case), native, err_msg=str(trial))
        np.testing.assert_array_equal(_jax_match(*case), native, err_msg=str(trial))


@pytest.mark.parametrize("ti", range(10))
def test_native_equals_numpy_and_jax_on_planted_ties(ti):
    """At threshold ti the planted prediction's IoU is exactly
    float32(IOU_THRESHOLDS[ti]): it matches there (and below), in all three.
    The JAX package's numpy fallback compares a float32 IoU with the
    float64 threshold and so misses the ties at 0.65, 0.7, 0.9 and 0.95,
    where float32 rounds the threshold down; the port's loop compares in
    float32, as both native matchers do."""
    from deal_yolo_daya_tpu import runtime as jax_rt
    from deal_yolo_daya_tpu.train import metrics as JM

    case = _planted_ties()[ti]
    native = rt.match_predictions_native(*case, M.IOU_THRESHOLDS.astype(np.float32))
    # prediction 0 takes GT 1 (IoU 1, first in the stable order); prediction
    # 1 then has GT 0 at IoU float32(t) alone: up to threshold ti
    assert native[0].all() and native[1, :ti + 1].all() and not native[1, ti + 1:].any()
    assert not native[2].any()  # another class
    np.testing.assert_array_equal(_numpy_loop(*case), native)
    np.testing.assert_array_equal(_jax_match(*case), native)
    orig = jax_rt.match_predictions_native
    jax_rt.match_predictions_native = lambda *a, **k: None
    try:
        jax_numpy = JM.match_predictions(*case)
    finally:
        jax_rt.match_predictions_native = orig
    rounds_down = np.float32(M.IOU_THRESHOLDS[ti]) < M.IOU_THRESHOLDS[ti]
    assert rounds_down == (ti in (3, 4, 8, 9))
    assert np.array_equal(jax_numpy, native) != rounds_down


def test_det_metrics_equal_with_and_without_the_library(monkeypatch):
    rng = np.random.default_rng(7)
    images = [_random_case(rng) for _ in range(40)] + _planted_ties()
    scores = [rng.uniform(0, 1, len(c[0])).astype(np.float32) for c in images]

    def compute():
        dm = M.DetMetrics(nc=3)
        for (pb, pc, gb, gc), s in zip(images, scores):
            dm.update(pb, s, pc, gb, gc)
        return dm.compute()

    with_lib = compute()
    monkeypatch.setattr(rt, "match_predictions_native", lambda *a, **k: None)
    without = compute()
    assert with_lib["map"] > 0
    for k in ("precision", "recall", "map50", "map"):
        assert with_lib[k] == without[k], k
    np.testing.assert_array_equal(with_lib["per_class_ap"], without["per_class_ap"])
    for k, v in with_lib["curves"].items():
        np.testing.assert_array_equal(v, without["curves"][k], err_msg=k)

"""The port's host augmentation (``train/augment.py``, numpy without cv2)
against the JAX package's (``train/augment.py``, cv2), under the same
``np.random.default_rng`` seeds, and the cv2-free synth dataset tool
against ``tools/synth_dataset.py``.

Stated tolerances (against the cv2 installed here, OpenCV 5):
- draws: each function leaves the generator where the JAX one leaves it,
  so every later draw is the same;
- boxes within 1e-4 px, classes and masks exactly;
- ``rgb_to_hsv`` exactly; ``hsv_to_rgb`` within 1 level and exact on
  99.99% of all 180 x 256 x 256 inputs laid out as an image (cv2 rounds
  where the port truncates on the pixels its vector loop leaves over, and
  lands elsewhere a level off on 0.005% in f32), ``hsv_jitter`` within 1
  level and exact on 99.5% of 128-wide images (all in cv2's vector loop);
- ``warp_affine`` within 1 level on every pixel and exact on 99.9% (cv2
  forms the source point with other f32 roundings; rotation moves a few);
- an augmented epoch (mosaic, affine with rotation and shear, mixup, HSV,
  flips; sources at imgsz, so neither package resizes): within 1 level on
  every pixel and exact on 99.9% (99.99% measured here);
- ``tools/synth_dataset_torch.py``: labels identical, the blur exact, the
  images exact on 99.9% of the pixels (shape edges are rasterised
  differently).
"""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu.train import augment as jax_aug
from deal_yolo_daya_tpu.train import data as jax_data
from deal_yolo_daya_tpu_torch.train import augment as port_aug
from deal_yolo_daya_tpu_torch.train import data as port_data

BOX_ATOL = 1e-4
WARP_EXACT = 0.999
JITTER_EXACT = 0.995
EPOCH_LEVELS, EPOCH_EXACT = 1, 0.999
SYNTH_EXACT = 0.999
TOOLS = Path(__file__).resolve().parents[1] / "tools"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and PyTorch's OpenMP threads spin-wait when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _image(seed, h=96, w=128):
    """Smooth colour fields plus noise (HSV of pure noise is all edges)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]
    return np.clip(img + rng.integers(-12, 13, img.shape), 0, 255).astype(np.uint8)


def _levels(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return int(d.max()), float((d == 0).mean())


def _same_stream(r1, r2):
    assert r1.random() == r2.random()


def test_rgb_to_hsv_matches_cv2():
    rng = np.random.default_rng(0)
    img = np.concatenate([rng.integers(0, 256, (64, 256, 3)),
                          np.stack(np.meshgrid(np.arange(256), np.arange(256)), -1)[..., [0, 1, 1]][:64],
                          np.full((1, 256, 3), 7), np.zeros((1, 256, 3))]).astype(np.uint8)
    np.testing.assert_array_equal(port_aug.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_matches_cv2():
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).reshape(-1, 256, 3).astype(np.uint8)
    levels, exact = _levels(port_aug.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert levels <= 1 and exact >= 0.9999, (levels, exact)


@pytest.mark.parametrize("gains", [(0.015, 0.7, 0.4), (0.5, 0.0, 0.9), (0.0, 0.0, 0.0)])
def test_hsv_jitter_matches_jax(gains):
    cfg_j = jax_aug.AugmentConfig(hsv_h=gains[0], hsv_s=gains[1], hsv_v=gains[2])
    cfg_p = port_aug.AugmentConfig(hsv_h=gains[0], hsv_s=gains[1], hsv_v=gains[2])
    for seed in range(4):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        img = _image(seed)
        levels, exact = _levels(port_aug.hsv_jitter(img, r2, cfg_p),
                                jax_aug.hsv_jitter(img, r1, cfg_j))
        assert levels <= 1 and exact >= JITTER_EXACT, (seed, levels, exact)
        _same_stream(r1, r2)


@pytest.mark.parametrize("angle, scale", [(0.0, 1.0), (12.5, 0.7), (-33.0, 1.4)])
def test_rotation_matrix_matches_cv2(angle, scale):
    np.testing.assert_array_equal(port_aug.rotation_matrix(angle, scale),
                                  cv2.getRotationMatrix2D((0, 0), angle, scale))


@pytest.mark.parametrize("angle, scale, shear", [(0, 0.8, 0), (0, 1.0, 0), (10, 1.3, 3),
                                                 (-25, 0.55, 8), (0, 1.5, 0)])
def test_warp_affine_matches_cv2(angle, scale, shear):
    img = _image(7, 120, 150)
    c = np.eye(3)
    c[:2, 2] = -75, -60
    r = np.eye(3)
    r[:2] = cv2.getRotationMatrix2D((0, 0), angle, scale)
    sh = np.eye(3)
    sh[0, 1] = np.tan(np.radians(shear))
    t = np.eye(3)
    t[:2, 2] = 0.47 * 128, 0.53 * 128
    m = (t @ sh @ r @ c)[:2]
    want = cv2.warpAffine(img, m, dsize=(128, 128), borderValue=(114, 114, 114))
    levels, exact = _levels(port_aug.warp_affine(img, m, 128), want)
    assert levels <= 1 and exact >= WARP_EXACT, (levels, exact)


def _boxes(rng, n, size):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32), rng.integers(0, 3, n)


@pytest.mark.parametrize("degrees, shear", [(0.0, 0.0), (10.0, 2.0)])
def test_random_affine_matches_jax(degrees, shear):
    cfg_j = jax_aug.AugmentConfig(degrees=degrees, shear=shear)
    cfg_p = port_aug.AugmentConfig(degrees=degrees, shear=shear)
    for seed in range(4):
        img = _image(seed)
        boxes, cls = _boxes(np.random.default_rng(seed + 50), 5, 96)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        ji, jb, jc = jax_aug.random_affine(img, boxes, cls, r1, cfg_j, 96)
        pi, pb, pc = port_aug.random_affine(img, boxes, cls, r2, cfg_p, 96)
        np.testing.assert_allclose(pb, jb, atol=BOX_ATOL, rtol=0)
        np.testing.assert_array_equal(pc, jc)
        levels, exact = _levels(pi, ji)
        assert levels <= 1 and exact >= WARP_EXACT, (seed, levels, exact)
        _same_stream(r1, r2)


def test_mosaic4_mixup_and_flips_match_jax():
    cfg_j = jax_aug.AugmentConfig(degrees=5.0, fliplr=0.5, flipud=0.5, bgr=0.5)
    cfg_p = port_aug.AugmentConfig(degrees=5.0, fliplr=0.5, flipud=0.5, bgr=0.5)
    for seed in range(4):
        rng = np.random.default_rng(seed + 100)
        imgs = [_image(seed * 4 + i, 96, 96) for i in range(4)]   # at imgsz: no resize
        labels = [_boxes(rng, int(rng.integers(0, 4)), 96) for _ in range(4)]
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        ji, jb, jc = jax_aug.mosaic4(imgs, [b for b, _ in labels], [c for _, c in labels], 96, r1,
                                     cfg_j)
        pi, pb, pc = port_aug.mosaic4(imgs, [b for b, _ in labels], [c for _, c in labels], 96,
                                      r2, cfg_p)
        np.testing.assert_allclose(pb, jb, atol=BOX_ATOL, rtol=0)
        np.testing.assert_array_equal(pc, jc)
        assert _levels(pi, ji)[0] <= 1
        (ji, jb, jc), (pi, pb, pc) = (jax_aug.mixup(ji, jb, jc, imgs[0], *labels[0], r1),
                                      port_aug.mixup(ji, jb, jc, imgs[0], *labels[0], r2))
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pb, jb)
        np.testing.assert_array_equal(pc, jc)
        ji, jb = jax_aug.flips(ji, jb, r1, cfg_j)
        pi, pb = port_aug.flips(pi, pb, r2, cfg_p)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pb, jb)
        _same_stream(r1, r2)


@pytest.fixture(scope="module")
def synth_yaml(tmp_path_factory):
    """8 + 4 shapes images at 96 px, PNG, from the cv2-free tool."""
    return _tool("synth_dataset_torch").generate(tmp_path_factory.mktemp("synth"), 8, 4, 96)


@pytest.mark.parametrize("epoch", [0, 1])
def test_augmented_epoch_matches_jax(synth_yaml, epoch):
    """DataLoader.epoch with augment: mosaic (with mixup), the affine with
    rotation and shear, HSV and flips, in the loader's worker threads."""
    kw = dict(mosaic=1.0, mixup=0.5, degrees=8.0, shear=2.0, flipud=0.3, bgr=0.2)
    loaders = []
    for mod, cfg in ((jax_data, jax_aug.AugmentConfig(**kw)),
                     (port_data, port_aug.AugmentConfig(**kw))):
        ds = mod.YoloDataset.from_yaml(str(synth_yaml), "train")
        loaders.append(mod.DataLoader(ds, 4, 96, augment=True, aug_config=cfg, seed=3,
                                      max_boxes=16))
    jl, pl = loaders
    pl.mosaic_off = jl.mosaic_off = epoch == 1   # epoch 1: the letterboxed affine path
    want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.gt_boxes, w.gt_boxes, atol=BOX_ATOL, rtol=0)
        for k in ("gt_classes", "gt_mask"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        assert g.gt_mask.any()
        levels, exact = _levels(g.images, w.images)
        assert levels <= EPOCH_LEVELS and exact >= EPOCH_EXACT, (levels, exact)


def test_synth_dataset_tool_matches_the_cv2_tool():
    cv2_tool, port_tool = _tool("synth_dataset"), _tool("synth_dataset_torch")
    img = _image(9, 80, 80)
    np.testing.assert_array_equal(port_tool.blur5(img), cv2.GaussianBlur(img, (5, 5), 0))
    same = total = 0
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(24):
        i1, b1, c1 = cv2_tool.make_image(160, r1)
        i2, b2, c2 = port_tool.make_image(160, r2)
        assert (b1, c1) == (b2, c2)
        same += int((i1 == i2).sum())
        total += i1.size
    _same_stream(r1, r2)
    assert same / total >= SYNTH_EXACT, same / total


def test_synth_dataset_tool_writes_the_same_labels(tmp_path):
    a = _tool("synth_dataset").generate(tmp_path / "cv2", 6, 2, 96, seed=4)
    b = _tool("synth_dataset_torch").generate(tmp_path / "port", 6, 2, 96, seed=4)
    for split in ("train", "val"):
        la = sorted((a.parent / "labels" / split).glob("*.txt"))
        lb = sorted((b.parent / "labels" / split).glob("*.txt"))
        assert [p.name for p in la] == [p.name for p in lb] and la
        assert all(x.read_text() == y.read_text() for x, y in zip(la, lb))
    img = port_data.YoloDataset.from_yaml(str(b), "train").image(0)
    assert img.shape == (96, 96, 3) and img.dtype == np.uint8

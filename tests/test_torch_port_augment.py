"""The port's on-card augmentation on the CPU against the JAX package's
``augment_batch`` on the same drawn numbers: the JAX draws are taken with
the key ``augment_batch`` splits, and handed to the port's ``apply``.

Tolerance of the images: XLA computes the separable taps as a matrix
product and may contract multiply-adds, so an f32 pixel can differ in its
last bits, and the final truncation to u8 can then move it by one level:
at most one level, in at most 0.1% of the pixels. Boxes are f32 arithmetic
in the same order (cos, sin and tan may differ in an ulp): within 1e-4 px;
the kept mask and the classes are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu.train import device_augment as jax_aug
from deal_yolo_daya_tpu_torch.train import device_augment as port_aug
from deal_yolo_daya_tpu_torch.train.device_augment import AugDraws, DeviceAugConfig, apply

S = 64
M = 8
NEUTRAL = dict(scale=0.0, translate=0.0, hsv_h=0, hsv_s=0, hsv_v=0, fliplr=0.0, flipud=0.0)


def _batch(b=4):
    """tests/test_device_augment.py's batch: flat sources of random sizes in
    an S x S canvas, one 20 px box each."""
    rng = np.random.default_rng(0)
    images = np.full((b, S, S, 3), 114, np.uint8)
    hw = np.zeros((b, 2), np.float32)
    boxes = np.zeros((b, M, 4), np.float32)
    classes = np.zeros((b, M), np.int32)
    mask = np.zeros((b, M), bool)
    for i in range(b):
        h, w = int(rng.integers(40, S + 1)), int(rng.integers(40, S + 1))
        hw[i] = (h, w)
        images[i, :h, :w] = rng.integers(0, 255, 3)
        x1, y1 = rng.integers(2, 12, 2)
        boxes[i, 0] = (x1, y1, x1 + 20, y1 + 20)
        classes[i, 0] = i % 3
        mask[i, 0] = True
    return images, hw, boxes, classes, mask


def _textured_batch(b=4):
    """Noise sources with two boxes each: every pixel tests the sampler."""
    rng = np.random.default_rng(1)
    images, hw, boxes, classes, mask = _batch(b)
    for i in range(b):
        h, w = int(hw[i, 0]), int(hw[i, 1])
        images[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        boxes[i, 1] = (20, 24, 38, 36)
        classes[i, 1], mask[i, 1] = 1, True
    return images, hw, boxes, classes, mask


def _jax_draws(key, b, cfg):
    """The numbers jax_aug.augment_batch draws from ``key``."""
    k_idx, k_u, k_hsv, k_flip, k_mix = jax.random.split(key, 5)
    k_lam, k_gate, k_perm = jax.random.split(k_mix, 3)
    gains = 1.0 + jax.random.uniform(k_hsv, (b, 3), minval=-1.0, maxval=1.0) * jnp.array(
        [cfg.hsv_h, cfg.hsv_s, cfg.hsv_v])
    arrays = (jax.random.randint(k_idx, (b, 3), 0, b), jax.random.uniform(k_u, (b, 10)), gains,
              jax.random.uniform(k_flip, (b, 3)), jax.random.randint(k_perm, (b,), 0, b),
              jax.random.beta(k_lam, 32.0, 32.0, (b,)), jax.random.uniform(k_gate, (b,)))
    return AugDraws(*(torch.from_numpy(np.array(a)) for a in arrays))


def _both(batch, seed, cfg, max_boxes=16):
    jcfg = jax_aug.DeviceAugConfig(**cfg._asdict())
    key = jax.random.PRNGKey(seed)
    want = jax_aug.augment_batch(*map(jnp.asarray, batch), key, S, jcfg, max_boxes=max_boxes)
    got = apply(*(torch.from_numpy(np.array(a)) for a in batch),
                _jax_draws(key, len(batch[0]), cfg), S, cfg, max_boxes)
    return [np.asarray(a) for a in want], [t.numpy() for t in got]


def _assert_match(want, got, max_level=1, max_share=1e-3, box_atol=1e-4):
    wi, wb, wc, wm = want
    gi, gb, gc, gm = got
    assert gi.shape == wi.shape and gi.dtype == np.uint8
    diff = np.abs(gi.astype(np.int32) - wi.astype(np.int32))
    assert diff.max() <= max_level, diff.max()
    assert (diff > 0).mean() <= max_share, (diff > 0).mean()
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gb, wb, atol=box_atol)


CASES = {
    "separable": DeviceAugConfig(),
    "separable_textured": DeviceAugConfig(),
    "gather_degrees10": DeviceAugConfig(degrees=10.0, shear=3.0, force_gather=True),
    "mixup": DeviceAugConfig(mixup=1.0, scale=0.3),
    "flips_bgr": DeviceAugConfig(fliplr=1.0, flipud=1.0, bgr=1.0),
    "single_image": DeviceAugConfig(mosaic=0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 3])
def test_apply_matches_jax_on_the_same_draws(name, seed):
    batch = _textured_batch() if name.endswith("textured") or "gather" in name else _batch()
    want, got = _both(batch, seed, CASES[name], max_boxes=32 if name == "mixup" else 16)
    _assert_match(want, got)
    assert got[3].any()


def test_warp_path_matches_jax():
    """Rotation and shear under 45 degrees take the two-pass bf16 warp in
    both, with the same bf16 roundings: the same tolerances as the other
    paths."""
    cfg = DeviceAugConfig(degrees=10.0, shear=5.0, scale=0.3)
    want, got = _both(_textured_batch(), 3, cfg)
    _assert_match(want, got)


def test_identity_transform_keeps_content():
    """scale 0, translate 0, no HSV or flips: pixels are source or fill and
    the primary box survives for some seeds."""
    images, hw, boxes, classes, mask = (torch.from_numpy(a) for a in _batch())
    cfg = DeviceAugConfig(**NEUTRAL)
    survived = 0
    for seed in range(6):
        out, _, _, om = port_aug.augment_batch(images, hw, boxes, classes, mask, seed, S, cfg)
        survived += int(om.sum())
        assert out.dtype == torch.uint8
    assert survived > 0


def test_flip_all_mirrors_image_and_boxes():
    batch = [torch.from_numpy(a) for a in _batch()]
    out, ob, _, om = port_aug.augment_batch(*batch, 0, S, DeviceAugConfig(**{**NEUTRAL,
                                                                              "fliplr": 1.0}))
    out2, ob2, _, om2 = port_aug.augment_batch(*batch, 0, S, DeviceAugConfig(**NEUTRAL))
    np.testing.assert_array_equal(out.numpy(), out2.numpy()[:, :, ::-1])
    m = (om & om2).numpy()
    np.testing.assert_allclose(ob.numpy()[m][:, 0], S - ob2.numpy()[m][:, 2], atol=1e-4)


def test_mosaic_gating_single_image_is_centred():
    """mosaic 0: each output is its own source letterbox-centred, with its
    own box shifted by the pad; partners never leak in."""
    images, hw, boxes, classes, mask = _batch()
    out, ob, _, om = (t.numpy() for t in port_aug.augment_batch(
        *(torch.from_numpy(a) for a in (images, hw, boxes, classes, mask)), 0, S,
        DeviceAugConfig(**{**NEUTRAL, "mosaic": 0.0})))
    assert (om.sum(1) == 1).all()
    for i in range(len(images)):
        h, w = int(hw[i, 0]), int(hw[i, 1])
        py, px = (S - h) // 2, (S - w) // 2
        np.testing.assert_allclose(out[i, py + 1:py + h - 1, px + 1:px + w - 1].astype(int),
                                   images[i, 1:h - 1, 1:w - 1].astype(int), atol=1)
        np.testing.assert_allclose(ob[i, 0], boxes[i, 0] + [(S - w) / 2, (S - h) / 2] * 2,
                                   atol=0.5)


def test_hsv_round_trip_and_unit_gains():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 16, 16, 3)).astype(np.float32))
    np.testing.assert_allclose(port_aug.hsv_to_rgb(port_aug.rgb_to_hsv(img)).numpy(),
                               img.numpy(), atol=1e-2)
    np.testing.assert_allclose(port_aug.hsv_jitter(img, torch.ones(2, 3)).numpy(), img.numpy(),
                               atol=1e-2)
    want = jax_aug.hsv_jitter_device(jnp.asarray(img[0].numpy()), jnp.asarray([1.01, 0.8, 1.2]))
    got = port_aug.hsv_jitter(img[:1], torch.tensor([[1.01, 0.8, 1.2]]))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_draws_have_the_reference_distributions():
    """The port's own draws: same shapes, ranges and, for Beta(32, 32),
    mean 0.5 and std 1/sqrt(4 * 65) ~ 0.062, over 4096 samples."""
    cfg = DeviceAugConfig(mixup=0.5)
    d = port_aug.draw(4096, torch.Generator().manual_seed(0), cfg)
    assert d.partners.shape == (4096, 3) and int(d.partners.min()) >= 0
    assert int(d.partners.max()) < 4096
    assert d.uniforms.shape == (4096, 10) and 0 <= float(d.uniforms.min())
    assert float(d.uniforms.max()) < 1
    lim = torch.tensor([cfg.hsv_h, cfg.hsv_s, cfg.hsv_v])
    assert ((d.gains - 1).abs() <= lim).all()
    assert abs(float(d.mix_lam.mean()) - 0.5) < 0.005
    assert abs(float(d.mix_lam.std()) - 1 / np.sqrt(260)) < 0.005
    again = port_aug.draw(4096, torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    assert port_aug.step_seed(3, 2, 5) == (3 << 20) + 2 * 16384 + 5

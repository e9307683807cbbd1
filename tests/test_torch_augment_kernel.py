"""The on-card augmentation's pixel kernel (``csrc/device_augment.cu``) on
the CPU: its algorithm, its route and its wrapper's checks. The kernel runs
only on the card (chip_smoke phase 42 holds it to ``pixels_plain`` there);
here a per-pixel reference written as the kernel computes (one quadrant's
source, picked by the point's side of the mosaic centre) is held to the
PyTorch version's four-quadrant masked sum, bit for bit in f32."""

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.ops.kernels import device_augment as pixel_kernel
from deal_yolo_daya_tpu_torch.ops.kernels.device_augment import PixelPlan, check_args
from deal_yolo_daya_tpu_torch.train import device_augment as da
from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

S = 24
B = 4
F = np.float32


def _batch(seed: int, b: int = B, s: int = S, m: int = 4):
    """Noise canvases of random content sizes (114 around), a few boxes each."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (b, s, s, 3), generator=g, dtype=torch.uint8)
    hw = torch.empty((b, 2))
    for i in range(b):
        h, w = (int(v) for v in torch.randint(s // 3, s + 1, (2,), generator=g))
        hw[i] = torch.tensor([h, w], dtype=torch.float32)
        images[i, h:], images[i, :, w:] = 114, 114
    u = torch.rand((b, m, 4), generator=g)
    wh = (0.2 + 0.6 * u[..., :2]) * hw.flip(-1)[:, None]
    xy = u[..., 2:] * (hw.flip(-1)[:, None] - wh)
    mask = torch.rand((b, m), generator=g) < 0.7
    boxes = torch.cat([xy, xy + wh], -1) * mask[..., None]
    classes = torch.randint(0, 80, (b, m), generator=g, dtype=torch.int32) * mask
    return images, hw, boxes, classes, mask


def _plan(hw, draws, cfg, s=S):
    """The mosaic part of a PixelPlan of a whole batch (no mixup)."""
    b = hw.shape[0]
    idx4 = torch.cat([torch.arange(b)[:, None], draws.partners], 1)
    made, _ = da._geometry(hw, idx4, draws.uniforms, s, cfg)
    no = torch.zeros(b, dtype=torch.bool)
    return PixelPlan(**made, gains=draws.gains, lr=no, ud=no, bgr=None, partner=None, lam=None)


def _kernel_pixel(images, hw, plan, m: int, y: int, x: int, s: int):
    """One pixel as the kernel computes it, in f32 scalars: the quadrant by
    the mosaic gate and the point's side of the centre, that source alone,
    bilinear rows first, FILL outside its content."""
    at = lambda name, *i: F(getattr(plan, name)[(m, *i)].item())  # noqa: E731
    gate = bool(plan.mosaic[m])
    cy1 = at("i11") * (F(y) - at("ty")) + F(s)
    cx1 = at("i00") * (F(x) - at("tx")) + F(s)
    q = 2 * int(gate and cy1 >= at("yc")) + int(gate and cx1 >= at("xc"))
    src = int(plan.idx4[m, q])
    hs, ws = F(hw[src, 0].item()), F(hw[src, 1].item())
    sx, sy = cx1 - at("origin_x", q), cy1 - at("origin_y", q)
    if not (sx >= F(-0.5) and sx <= ws - F(0.5) and sy >= F(-0.5) and sy <= hs - F(0.5)):
        return [F(da.FILL)] * 3, False
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    xa, xb = (min(max(int(x0) + k, 0), s - 1) for k in (0, 1))
    ya, yb = (min(max(int(y0) + k, 0), s - 1) for k in (0, 1))
    p = images[src].numpy().astype(F)
    t0 = (F(1) - fy) * p[ya, xa] + fy * p[yb, xa]
    t1 = (F(1) - fy) * p[ya, xb] + fy * p[yb, xb]
    return list((F(1) - fx) * t0 + fx * t1), True


@pytest.mark.parametrize("mosaic", [1.0, 0.0], ids=["gate_on", "gate_off"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_quadrant_pick_equals_masked_sum(mosaic, seed):
    """The kernel's one pick equals ``_resample``'s separable route (all
    four quadrants sampled, three masked away, summed) bit for bit, fill
    pixels included."""
    images, hw, *_ = _batch(seed)
    cfg = DeviceAugConfig(mosaic=mosaic)
    draws = da.draw(B, torch.Generator().manual_seed(seed + 100), cfg)
    plan = _plan(hw, draws, cfg)
    want = da._resample(images, hw, plan, S, cfg).numpy()
    got = np.empty_like(want)
    inside = np.zeros(want.shape[:3], bool)
    for m in range(B):
        for y in range(S):
            for x in range(S):
                got[m, y, x], inside[m, y, x] = _kernel_pixel(images, hw, plan, m, y, x, S)
    assert inside.any() and not inside.all()  # sampled pixels and fill pixels
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


CONFIGS = [DeviceAugConfig(), DeviceAugConfig(mosaic=0.0, mixup=0.5),
           DeviceAugConfig(force_gather=True), DeviceAugConfig(degrees=10.0),
           DeviceAugConfig(shear=2.0), DeviceAugConfig(degrees=50.0),
           DeviceAugConfig(degrees=10.0, force_gather=True), DeviceAugConfig(shear=-60.0)]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_picks_the_kernel_exactly_when_separable_on_the_card(device):
    """A property of the configuration and the device, never of the data:
    the kernel exactly when degrees == shear == 0 on a CUDA device
    (``force_gather`` acts on rotation and shear alone); otherwise the JAX
    package's PyTorch resamplers."""
    for cfg in CONFIGS:
        separable = cfg.degrees == 0.0 and cfg.shear == 0.0
        kernel = separable and device == "cuda"
        want = ("kernel" if kernel else "separable" if separable
                else "gather" if cfg.force_gather or max(abs(cfg.degrees), abs(cfg.shear)) > 45
                else "warp")
        assert da.route(cfg, torch.device(device)) == want, cfg


@pytest.mark.parametrize("case", [
    dict(cfg=DeviceAugConfig(), rows=None),
    dict(cfg=DeviceAugConfig(mixup=0.5), rows=None),
    dict(cfg=DeviceAugConfig(mixup=0.5), rows=slice(2, 4)),
    dict(cfg=DeviceAugConfig(fliplr=1.0, flipud=1.0, bgr=1.0, mosaic=0.0), rows=slice(0, 2)),
], ids=["default", "mixup", "mixup_rows", "flips_bgr_rows"])
def test_apply_hands_the_kernel_a_plan_it_takes(case, monkeypatch):
    """On the kernel's route ``apply`` hands ``launch`` a plan that passes
    its checks, and whatever the kernel returns for it (here the plain
    version on the same plan) is the image the plain route makes."""
    cfg, rows = case["cfg"], case["rows"]
    batch = _batch(7)
    draws = da.draw(B, torch.Generator().manual_seed(5), cfg)
    want = da.apply(*batch, draws, S, cfg, 16, rows)
    seen = []

    def fake_launch(images, hw, plan):
        check_args(images, hw, plan)
        seen.append(plan)
        return da.pixels_plain(images, hw, plan, S, cfg)

    monkeypatch.setattr(da, "route", lambda c, d: "kernel")
    monkeypatch.setattr(pixel_kernel, "launch", fake_launch)
    got = da.apply(*batch, draws, S, cfg, 16, rows)
    assert len(seen) == 1
    assert (seen[0].partner is not None) == (cfg.mixup > 0)
    assert (seen[0].bgr is not None) == (cfg.bgr > 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("imgsz", [S - 8, S + 8], ids=["smaller", "larger"])
def test_apply_refuses_canvases_of_another_size(imgsz):
    """The canvases' side is the output's: both routes make (n, imgsz,
    imgsz, 3), so ``apply`` raises on canvases of another size."""
    batch = _batch(4)
    draws = da.draw(B, torch.Generator().manual_seed(4), DeviceAugConfig())
    with pytest.raises(ValueError, match="device_augment"):
        da.apply(*batch, draws, imgsz)


def _good_args():
    images, hw, *_ = _batch(3)
    cfg = DeviceAugConfig(mixup=0.5, bgr=0.5)
    draws = da.draw(B, torch.Generator().manual_seed(3), cfg)
    plan = _plan(hw, draws, cfg)._replace(partner=draws.mix_j, lam=draws.mix_lam,
                                          bgr=draws.flips[:, 2] < 0.5)
    return images, hw, plan


BAD = {
    "images_dtype": lambda im, hw, p: (im.float(), hw, p),
    "images_not_square": lambda im, hw, p: (im[:, :-1], hw, p),
    "images_channels": lambda im, hw, p: (im[..., :2], hw, p),
    "hw_dtype": lambda im, hw, p: (im, hw.double(), p),
    "hw_rows": lambda im, hw, p: (im, hw[:-1], p),
    "idx4_dtype": lambda im, hw, p: (im, hw, p._replace(idx4=p.idx4.int())),
    "origin_shape": lambda im, hw, p: (im, hw, p._replace(origin_x=p.origin_x[:, :3])),
    "i00_dtype": lambda im, hw, p: (im, hw, p._replace(i00=p.i00.double())),
    "mosaic_dtype": lambda im, hw, p: (im, hw, p._replace(mosaic=p.mosaic.float())),
    "gains_shape": lambda im, hw, p: (im, hw, p._replace(gains=p.gains[:, :2])),
    "flip_rows": lambda im, hw, p: (im, hw, p._replace(lr=p.lr[:-1])),
    "more_outputs_than_made": lambda im, hw, p: (im, hw, p._replace(
        gains=torch.ones((B + 1, 3)), lr=torch.zeros(B + 1, dtype=torch.bool))),
    "partner_without_lam": lambda im, hw, p: (im, hw, p._replace(lam=None)),
    "lam_dtype": lambda im, hw, p: (im, hw, p._replace(lam=p.lam.half())),
    "not_contiguous": lambda im, hw, p: (im, hw, p._replace(
        origin_y=p.origin_y.t().contiguous().t())),
    "on_the_cpu": lambda im, hw, p: (im, hw, p),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    """``launch`` raises ValueError, without a card, on a wrong dtype, shape,
    pairing or layout, and for tensors that are not on a CUDA device."""
    before = pixel_kernel.launches
    args = BAD[name](*_good_args())
    with pytest.raises(ValueError, match="device_augment"):
        pixel_kernel.launch(*args)
    if name != "on_the_cpu":
        with pytest.raises(ValueError, match="device_augment"):
            check_args(*args)
    else:
        check_args(*args)  # the arguments themselves are right
    assert pixel_kernel.launches == before

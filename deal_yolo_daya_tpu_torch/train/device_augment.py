"""On-card augmentation: mosaic, random affine, mixup, HSV, flips and the
box compaction, on a whole batch at once.

Counterpart of ``deal_yolo_daya_tpu/train/device_augment.py::augment_batch``.
The host only decodes and keep-ratio resizes each image into a fixed (S, S)
canvas (``DataLoader.load_raw``); the rest runs here, on the batch's device:

- the 4-image mosaic is composed implicitly: every output pixel maps back
  through the random affine to the 2S x 2S mosaic canvas, the canvas
  quadrant picks one of four sources, and the pixel is sampled bilinearly
  from it (neighbour indices clipped to the source, weights from the
  unclipped floor: border replication);
- boxes ride the same transforms (the axis-aligned box of the four
  transformed corners), filtered as the host augmentation filters them;
- mixup, HSV gains and flips act on whole images; the kept boxes are moved to
  the front and truncated to ``max_boxes``.

Three resamplers, chosen by the JAX package's rule, a property of the
configuration (``route``): without rotation and shear the map is
separable, and each output row and column samples its two source taps
directly (the JAX package writes the same taps as one-hot matrices for the
TPU's matrix unit); up to 45 degrees a two-pass shear warp in bf16; beyond
that, or with ``force_gather``, the exact per-pixel gather.

On a CUDA device the separable route's pixels (the mosaic's sampling, the
fill, mixup, HSV, the flips and the u8 store) are one hand-written kernel
(``ops/kernels/device_augment.py``, ``csrc/device_augment.cu``): it picks
each pixel's one quadrant source instead of sampling all four and masking
three away, and keeps every f32 intermediate out of device memory, with
the same draws and the same roundings. ``apply`` launches it or raises;
``pixels_plain`` is its plain version, the separable route on the CPU. The
per-sample numbers and the boxes are PyTorch on every route; the warp and
gather routes, and every route on the CPU, are PyTorch throughout.

The random numbers are drawn apart from their use: ``draw`` takes them from
a ``torch.Generator`` on the batch's device, ``apply`` uses them. The two
packages' generators give different numbers for a seed, so the tests hand
the JAX package's draws to ``apply``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.kernels import device_augment as pixel_kernel
from ..ops.kernels.device_augment import PixelPlan

FILL = 114.0


class DeviceAugConfig(NamedTuple):
    mosaic: float = 1.0
    mixup: float = 0.0
    scale: float = 0.5
    translate: float = 0.1
    degrees: float = 0.0
    shear: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0
    bgr: float = 0.0
    # the exact per-pixel gather for rotation and shear instead of the
    # two-pass warp (tests, numerics comparisons)
    force_gather: bool = False


class AugDraws(NamedTuple):
    """The random numbers of one augmented batch of B samples."""
    partners: torch.Tensor   # (B, 3) int64: the mosaic's other three sources
    uniforms: torch.Tensor   # (B, 10) f32: 0 yc, 1 xc, 2 scale, 3 tx, 4 ty,
    #                          5 mosaic gate, 6 angle, 7/8 shear x/y
    gains: torch.Tensor      # (B, 3) f32 HSV gains around 1
    flips: torch.Tensor      # (B, 3) f32 uniforms: left-right, up-down, bgr
    mix_j: torch.Tensor      # (B,) int64 mixup partner
    mix_lam: torch.Tensor    # (B,) f32 Beta(32, 32) weight
    mix_u: torch.Tensor      # (B,) f32 mixup gate uniform


def draw(b: int, generator: torch.Generator, cfg: DeviceAugConfig,
         device=None) -> AugDraws:
    """Draw one batch's numbers from ``generator`` (on ``device``). Beta(32,
    32) is X / (X + Y) with X, Y ~ Gamma(32, 1), each a sum of 32 unit
    exponentials."""
    kw = dict(generator=generator, device=device)
    partners = torch.randint(0, b, (b, 3), **kw)
    uniforms = torch.rand((b, 10), **kw)
    # the gains column by column, by Python scalars: a tensor of them made on
    # the card would be a host-to-device copy, which waits for the stream
    u = torch.rand((b, 3), **kw) * 2.0 - 1.0
    gains = 1.0 + torch.stack([u[:, 0] * cfg.hsv_h, u[:, 1] * cfg.hsv_s, u[:, 2] * cfg.hsv_v],
                              dim=-1)
    flips = torch.rand((b, 3), **kw)
    mix_j = torch.randint(0, b, (b,), **kw)
    gamma = -torch.log1p(-torch.rand((b, 2, 32), **kw)).sum(-1)
    mix_lam = gamma[:, 0] / gamma.sum(-1)
    mix_u = torch.rand((b,), **kw)
    return AugDraws(partners, uniforms, gains, flips, mix_j, mix_lam, mix_u)


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The per-step augmentation seed of the JAX Trainer."""
    return (seed << 20) + epoch * 16384 + step


# ---------------------------------------------------------------- colour


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float 0-255 -> h in [0, 180), s and v in [0, 255] (cv2's ranges)."""
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0, 1.0, delta)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, h)
    h = torch.remainder(h / 6.0, 1.0) * 180.0
    s = torch.where(maxc == 0, 0.0, delta / torch.where(maxc == 0, 1.0, maxc)) * 255.0
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] / 180.0 * 6.0, hsv[..., 1] / 255.0, hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sector = [i == k for k in range(6)]

    def select(vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(sector[k], vals[k], out)
        return out

    return torch.stack([select([v, q, p, p, t, v]), select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], dim=-1)


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """img (B, S, S, 3) 0-255 float; gains (B, 3) multiplicative around 1."""
    hsv = rgb_to_hsv(img)
    g = gains[:, None, None, :]
    h = torch.remainder(hsv[..., 0] * g[..., 0], 180.0)
    s = torch.clamp(hsv[..., 1] * g[..., 1], 0, 255)
    v = torch.clamp(hsv[..., 2] * g[..., 2], 0, 255)
    return torch.clamp(hsv_to_rgb(torch.stack([h, s, v], dim=-1)), 0, 255)


# ---------------------------------------------------------------- geometry


def _b1(t: torch.Tensor) -> torch.Tensor:
    """A per-sample (B,) value as (B, 1)."""
    return t[:, None]


def _b2(t: torch.Tensor) -> torch.Tensor:
    """A per-sample (B,) value as (B, 1, 1)."""
    return t[:, None, None]


def _taps(coords: torch.Tensor, n: int):
    """Two-tap bilinear sampling along one axis of length n: clipped
    neighbour indices and the fraction, from the unclipped floor."""
    x0 = torch.floor(coords)
    frac = coords - x0
    i0 = x0.long()
    return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), frac


def _shift_rows(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C), delta (N, H) >= 0 -> out[n, y, x] = img[n, y, x +
    delta[n, y]] with edge clamp: a two-tap fractional blend in img's dtype,
    then the integer part as a clamped gather (the TPU version shifts in
    log2(W) whole-array stages; the values are the same)."""
    w = img.shape[2]
    d = torch.clamp(delta, 0.0, w - 1.0)
    k = torch.floor(d)
    f = (d - k)[..., None, None].to(img.dtype)
    nxt = torch.cat([img[:, :, 1:], img[:, :, -1:]], 2)
    out = img * (1.0 - f) + nxt * f
    cols = torch.clamp(torch.arange(w, device=img.device) + k.long()[..., None], max=w - 1)
    return torch.gather(out, 2, cols[..., None].expand(-1, -1, -1, img.shape[3]))


def _resample_cols(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C) bf16, coords (N, W_out) -> (N, H, W_out, C): each
    output column blends two source columns with bf16 weights, the products
    summed in f32 and rounded to bf16 (a bf16 matrix product of the one-hot
    weights)."""
    n, h, w, c = img.shape
    i0, i1, frac = _taps(coords, w)
    w0 = (1.0 - frac).to(img.dtype).float()[:, None, :, None]
    w1 = frac.to(img.dtype).float()[:, None, :, None]
    take = lambda i: torch.gather(img, 2, i[:, None, :, None].expand(n, h, -1, c)).float()  # noqa: E731
    return (w0 * take(i0) + w1 * take(i1)).to(img.dtype)


def _bilinear_sample(srcs: torch.Tensor, src4: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """srcs (B, S, S, 3) u8, src4 (B, 4) source rows, x and y (B, 4, S, S)
    source coordinates -> (B, 4, S, S, 3) f32, per-pixel bilinear."""
    s = srcs.shape[1]
    x0i, x1i, fx = _taps(x, s)
    y0i, y1i, fy = _taps(y, s)
    fx, fy = fx[..., None], fy[..., None]
    img = src4[:, :, None, None]
    p00, p01 = srcs[img, y0i, x0i].float(), srcs[img, y0i, x1i].float()
    p10, p11 = srcs[img, y1i, x0i].float(), srcs[img, y1i, x1i].float()
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def _resampler(cfg: DeviceAugConfig) -> str:
    """The configuration's resampler in PyTorch, by the JAX package's rule:
    ``"separable"`` without rotation and shear, ``"warp"`` up to 45
    degrees, ``"gather"`` beyond or with ``force_gather``."""
    if cfg.degrees == 0.0 and cfg.shear == 0.0:
        return "separable"
    if not cfg.force_gather and max(abs(cfg.degrees), abs(cfg.shear)) <= 45.0:
        return "warp"
    return "gather"


def route(cfg: DeviceAugConfig, device) -> str:
    """The pixel path's route, a property of the configuration and the
    device: ``"kernel"`` (``csrc/device_augment.cu``) on the separable route
    on a CUDA device; otherwise the PyTorch resampler (``_resampler``)."""
    resampler = _resampler(cfg)
    if resampler == "separable" and torch.device(device).type == "cuda":
        return "kernel"
    return resampler


def _geometry(hw, idx4, u, imgsz: int, cfg: DeviceAugConfig):
    """The mosaic and affine of every sample made: ``idx4`` (m, 4) and ``u``
    (m, 10) give the m samples, their four sources indexing the raw batch.
    A sample whose gate u[:, 5] >= cfg.mosaic takes the single-image path:
    its own source centred on the canvas, the partners parked off the
    canvas. -> (the ``PixelPlan`` fields of the m samples, the box path's
    scale and forward matrix (sc, f00, f01, f10, f11))."""
    s = imgsz
    bsz = idx4.shape[0]
    dev = idx4.device
    use_mosaic = u[:, 5] < cfg.mosaic                         # (B,)
    yc = s // 2 + u[:, 0] * s                                 # in [s/2, 3s/2)
    xc = s // 2 + u[:, 1] * s
    hs, ws = hw[idx4][..., 0], hw[idx4][..., 1]               # (B, 4)
    cxc = cyc = float(s)                                      # centre of the 2S canvas
    off = torch.full((bsz,), 4.0 * s, device=dev)
    # each source's origin on the canvas: q0 top-left ... q3 bottom-right of (xc, yc)
    m_ox = torch.stack([xc - ws[:, 0], xc, xc - ws[:, 2], xc], 1)
    m_oy = torch.stack([yc - hs[:, 0], yc - hs[:, 1], yc, yc], 1)
    s_ox = torch.stack([cxc - ws[:, 0] / 2, off, off, off], 1)
    s_oy = torch.stack([cyc - hs[:, 0] / 2, off, off, off], 1)
    origin_x = torch.where(use_mosaic[:, None], m_ox, s_ox)   # (B, 4)
    origin_y = torch.where(use_mosaic[:, None], m_oy, s_oy)

    # the affine canvas -> output: translate @ shear @ rotate-scale about the
    # canvas centre
    sc = 1.0 + cfg.scale * (2.0 * u[:, 2] - 1.0)
    tx = (0.5 + cfg.translate * (2.0 * u[:, 3] - 1.0)) * s
    ty = (0.5 + cfg.translate * (2.0 * u[:, 4] - 1.0)) * s
    deg2rad = math.pi / 180.0
    ang = cfg.degrees * (2.0 * u[:, 6] - 1.0) * deg2rad
    alpha, beta = sc * torch.cos(ang), sc * torch.sin(ang)
    sh_x = torch.tan(cfg.shear * (2.0 * u[:, 7] - 1.0) * deg2rad)
    sh_y = torch.tan(cfg.shear * (2.0 * u[:, 8] - 1.0) * deg2rad)
    f00 = alpha + sh_x * -beta
    f01 = beta + sh_x * alpha
    f10 = sh_y * alpha - beta
    f11 = sh_y * beta + alpha
    det = f00 * f11 - f01 * f10
    i00, i01, i10, i11 = f11 / det, -f01 / det, -f10 / det, f00 / det
    made = dict(idx4=idx4, origin_x=origin_x, origin_y=origin_y, i00=i00, i01=i01, i10=i10,
                i11=i11, tx=tx, ty=ty, xc=xc, yc=yc, mosaic=use_mosaic)
    return made, (sc, f00, f01, f10, f11)


def _resample(images, hw, plan: PixelPlan, imgsz: int, cfg: DeviceAugConfig) -> torch.Tensor:
    """The mosaic's pixels of the m samples of ``plan`` in PyTorch, by the
    route's resampler: every output pixel maps back through the affine to
    the 2S canvas, whose quadrant picks the source -> (m, S, S, 3) f32, FILL
    outside the sources' content."""
    s = imgsz
    idx4, origin_x, origin_y = plan.idx4, plan.origin_x, plan.origin_y
    i00, i01, i10, i11, tx, ty = plan.i00, plan.i01, plan.i10, plan.i11, plan.tx, plan.ty
    use_mosaic, xc, yc = plan.mosaic, plan.xc, plan.yc
    bsz = idx4.shape[0]
    dev = images.device
    hs, ws = hw[idx4][..., 0], hw[idx4][..., 1]               # (B, 4)
    cxc = cyc = float(s)
    ys = torch.arange(s, dtype=torch.float32, device=dev)
    xs = ys
    src4 = idx4[:, :, None]
    resampler = _resampler(cfg)
    if resampler == "separable":
        # every output column samples two source columns, every output row
        # two source rows (rows first, as the JAX einsums)
        cx1 = _b1(i00) * (xs - _b1(tx)) + cxc                # (B, S)
        cy1 = _b1(i11) * (ys - _b1(ty)) + cyc
        sx4 = cx1[:, None, :] - origin_x[:, :, None]         # (B, 4, S)
        sy4 = cy1[:, None, :] - origin_y[:, :, None]
        y0i, y1i, fy = _taps(sy4, s)
        x0i, x1i, fx = _taps(sx4, s)
        fy = fy[..., None, None]
        tmp = (1.0 - fy) * images[src4, y0i].float() + fy * images[src4, y1i].float()
        rows = torch.arange(s, device=dev)[None, None, :, None]
        q4 = torch.arange(4, device=dev)[None, :, None, None]
        b4 = torch.arange(bsz, device=dev)[:, None, None, None]
        fx = fx[:, :, None, :, None]
        sampled = ((1.0 - fx) * tmp[b4, q4, rows, x0i[:, :, None, :]]
                   + fx * tmp[b4, q4, rows, x1i[:, :, None, :]])    # (B, 4, S, S, 3)
        sel_x = _b1(use_mosaic) & (cx1 >= _b1(xc))          # column in the right half
        sel_y = _b1(use_mosaic) & (cy1 >= _b1(yc))          # row in the bottom half
        colsel = torch.stack([~sel_x, sel_x, ~sel_x, sel_x], 1)
        rowsel = torch.stack([~sel_y, ~sel_y, sel_y, sel_y], 1)
        vx4 = (sx4 >= -0.5) & (sx4 <= ws[:, :, None] - 0.5)
        vy4 = (sy4 >= -0.5) & (sy4 <= hs[:, :, None] - 0.5)
        m4 = ((rowsel & vy4)[:, :, :, None] & (colsel & vx4)[:, :, None, :]).float()
        pick = (sampled * m4[..., None]).sum(1)
        pick_valid = m4.sum(1) > 0.5
    else:
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        dx, dy = gx - _b2(tx), gy - _b2(ty)
        canvas_x = _b2(i00) * dx + _b2(i01) * dy + cxc   # (B, S, S)
        canvas_y = _b2(i10) * dx + _b2(i11) * dy + cyc
        qx = (canvas_x >= _b2(xc)).long()
        qy = (canvas_y >= _b2(yc)).long()
        quad = torch.where(_b2(use_mosaic), qy * 2 + qx, 0)  # 0 TL 1 TR 2 BL 3 BR
        src_x4 = canvas_x[:, None] - origin_x[:, :, None, None]   # (B, 4, S, S)
        src_y4 = canvas_y[:, None] - origin_y[:, :, None, None]
        if resampler == "warp":
            sampled = _warp(images, idx4, origin_x, origin_y, tx, ty,
                            (i00, i01, i10, i11), s)
        else:
            sampled = _bilinear_sample(images, idx4, src_x4, src_y4)
        valid4 = ((src_x4 >= -0.5) & (src_x4 <= ws[:, :, None, None] - 0.5)
                  & (src_y4 >= -0.5) & (src_y4 <= hs[:, :, None, None] - 0.5))
        onehot = torch.nn.functional.one_hot(quad, 4).permute(0, 3, 1, 2).float()  # (B, 4, S, S)
        pick = (sampled * onehot[..., None]).sum(1)
        pick_valid = (valid4.float() * onehot).sum(1) > 0.5
    return torch.where(pick_valid[..., None], pick, FILL)


def _mosaic_boxes(boxes, classes, mask, made, fwd, imgsz: int):
    """The boxes of every sample made (``_geometry``'s numbers): source
    canvas -> mosaic canvas (clipped to it) -> the four corners through the
    affine, their axis-aligned box, then the host augmentation's filter ->
    (boxes (B, 4M, 4), classes (B, 4M), keep (B, 4M))."""
    s = imgsz
    idx4, origin_x, origin_y, tx, ty = (made[k] for k in ("idx4", "origin_x", "origin_y",
                                                          "tx", "ty"))
    sc, f00, f01, f10, f11 = fwd
    bsz = idx4.shape[0]
    cxc = cyc = float(s)
    origin = torch.stack([origin_x, origin_y, origin_x, origin_y], -1)[:, :, None, :]
    b_can = torch.clamp((boxes[idx4] + origin).reshape(bsz, -1, 4), 0, 2 * s)
    x1, y1, x2, y2 = b_can.unbind(-1)                         # (B, 4M)
    cx = torch.stack([x1, x2, x2, x1], -1) - cxc              # (B, 4M, 4 corners)
    cy = torch.stack([y1, y1, y2, y2], -1) - cyc
    ox = _b2(f00) * cx + _b2(f01) * cy + _b2(tx)
    oy = _b2(f10) * cx + _b2(f11) * cy + _b2(ty)
    b_out = torch.stack([ox.amin(-1), oy.amin(-1), ox.amax(-1), oy.amax(-1)], -1)
    out_cls = classes[idx4].reshape(bsz, -1)
    out_mask = mask[idx4].reshape(bsz, -1)

    clipped = torch.clamp(b_out, 0, s)
    bw = clipped[..., 2] - clipped[..., 0]
    bh = clipped[..., 3] - clipped[..., 1]
    # the host filter: sides over 2 px, at least 10% of the scaled area
    # inside, aspect under 100
    area0 = (x2 - x1) * (y2 - y1) * _b1(sc) * _b1(sc)
    aspect = torch.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = (out_mask & (bw > 2) & (bh > 2)
            & (bw * bh / (torch.abs(area0) + 1e-9) > 0.1) & (aspect < 100))
    return clipped, out_cls, keep


def _warp(images, idx4, origin_x, origin_y, tx, ty, inv, s: int) -> torch.Tensor:
    """The two-pass shear/scale warp of the JAX package (rotations and shears
    up to 45 degrees): a horizontal pass x = pA*x'' + qA*y + rA (a sub-pixel
    shift of each row, then a shared-slope resample of the columns), then a
    vertical pass y = i11*y' + i10*x'' + wB over the columns, in bf16.
    -> (B, 4, S, S, 3) f32."""
    i00, i01, i10, i11 = inv
    bsz = idx4.shape[0]
    bf = torch.bfloat16
    cxc = cyc = float(s)
    pos = torch.arange(s, dtype=torch.float32, device=images.device)
    i11s = torch.where(torch.abs(i11) < 1e-4, 1e-4, i11)
    qa = i01 / i11s
    pa = (i00 * i11 - i01 * i10) / i11s
    constx = cxc - i00 * tx - i01 * ty
    wb = cyc - i10 * tx - i11 * ty
    ra = constx - qa * wb
    ra_q = _b1(ra) + _b1(qa) * origin_y - origin_x            # (B, 4)
    wb_q = _b1(wb) - origin_y
    fs = float(s)
    flat = lambda t: t.reshape(bsz * 4, *t.shape[2:])  # noqa: E731  (B, 4, ...) -> (4B, ...)
    # pass H over the source rows
    r0h = ra_q + _b1(torch.clamp(qa * (fs - 1.0), max=0.0))
    delta_h = _b1(qa)[..., None] * pos + (ra_q - r0h)[..., None]       # (B, 4, S)
    shifted = _shift_rows(flat(images[idx4].to(bf)), flat(delta_h))
    bx = _b1(pa)[..., None] * pos + r0h[..., None]
    h_out = _resample_cols(shifted, flat(bx))
    # pass V over the columns of its output
    r0v = wb_q + _b1(torch.clamp(i10 * (fs - 1.0), max=0.0))
    delta_v = _b1(i10)[..., None] * pos + (wb_q - r0v)[..., None]
    shifted_v = _shift_rows(h_out.transpose(1, 2), flat(delta_v))
    by = _b1(i11)[..., None] * pos + r0v[..., None]
    sampled = _resample_cols(shifted_v, flat(by)).transpose(1, 2)
    return sampled.float().reshape(bsz, 4, s, s, 3)


# ---------------------------------------------------------------- the batch


def pixels_plain(images: torch.Tensor, hw: torch.Tensor, plan: PixelPlan, imgsz: int,
                 cfg: DeviceAugConfig = DeviceAugConfig()) -> torch.Tensor:
    """The pixel path in PyTorch: the mosaic of the plan's m samples by the
    configuration's resampler, mixup with the partners, the HSV gains, the
    flips and the u8 store -> (n, S, S, 3) uint8. On the separable route
    ``ops/kernels/device_augment.py::launch`` computes the same in one
    kernel."""
    out = _resample(images, hw, plan, imgsz, cfg)
    n = plan.gains.shape[0]
    if plan.partner is not None:
        # Beta(32, 32) blend with another augmented sample of the batch;
        # before HSV and flips, as on the host
        lam = plan.lam[:, None, None, None]
        out = lam * out[:n] + (1.0 - lam) * out[plan.partner]
    out = hsv_jitter(out, plan.gains)
    out = torch.where(plan.lr[:, None, None, None], out.flip(2), out)
    out = torch.where(plan.ud[:, None, None, None], out.flip(1), out)
    if plan.bgr is not None:  # channel swap
        out = torch.where(plan.bgr[:, None, None, None], out.flip(3), out)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def apply(images: torch.Tensor, hw: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
          mask: torch.Tensor, draws: AugDraws, imgsz: int,
          cfg: DeviceAugConfig = DeviceAugConfig(), max_boxes: int = 128,
          rows: Optional[slice] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Augment a batch with the given draws.

    images (B, S, S, 3) u8 keep-ratio resized, top-left; hw (B, 2) content
    (h, w); boxes (B, M, 4) xyxy in canvas pixels, classes (B, M) int,
    mask (B, M) bool -> (images (B, S, S, 3) u8, boxes (B, K, 4), classes
    (B, K), mask (B, K)) with K = min(max_boxes, 4M, or 8M with mixup),
    kept boxes first. The pixels go through the kernel or PyTorch by
    ``route``; the boxes are PyTorch either way.

    ``rows`` makes only those samples of the batch (a data-parallel rank's
    rows, ``parallel.DataParallel.rows``): the same values as the whole
    batch's rows, since mosaic partners index the whole raw batch and a
    mixup partner's sample is made beside them."""
    if tuple(images.shape[1:3]) != (imgsz, imgsz):
        raise ValueError(f"device_augment: canvases {tuple(images.shape[1:3])}, imgsz {imgsz}")
    b = images.shape[0]
    dev = images.device
    sel = rows if rows is not None else slice(None)   # views of the draws
    own = torch.arange(b, device=dev)[sel]
    u, partners = draws.uniforms[sel], draws.partners[sel]
    made = own
    if cfg.mixup > 0 and rows is not None:  # the mixup partners' samples too
        made = torch.cat([own, draws.mix_j[own]])
        u, partners = draws.uniforms[made], draws.partners[made]
    idx4 = torch.cat([made[:, None], partners], 1)
    geometry, fwd = _geometry(hw, idx4, u, imgsz, cfg)
    out_boxes, out_cls, out_keep = _mosaic_boxes(boxes, classes, mask, geometry, fwd, imgsz)
    n = own.shape[0]

    partner = lam = None
    if cfg.mixup > 0:
        # each sample's mixup partner among the made samples; labels unioned
        partner = torch.arange(n, 2 * n, device=dev) if rows is not None else draws.mix_j
        do = draws.mix_u[sel] < cfg.mixup
        lam = torch.where(do, draws.mix_lam[sel], 1.0)
        out_boxes = torch.cat([out_boxes[:n], out_boxes[partner]], 1)
        out_cls = torch.cat([out_cls[:n], out_cls[partner]], 1)
        out_keep = torch.cat([out_keep[:n], out_keep[partner] & do[:, None]], 1)

    draws = AugDraws(*(t[sel] for t in draws))
    u = draws.flips
    s = imgsz
    do_lr, do_ud = u[:, 0] < cfg.fliplr, u[:, 1] < cfg.flipud
    plan = PixelPlan(**geometry, gains=draws.gains, lr=do_lr, ud=do_ud,
                     bgr=u[:, 2] < cfg.bgr if cfg.bgr > 0 else None, partner=partner, lam=lam)
    if route(cfg, dev) == "kernel":
        out_imgs = pixel_kernel.launch(images.contiguous(), hw.contiguous(), plan)
    else:
        out_imgs = pixels_plain(images, hw, plan, imgsz, cfg)
    bx = out_boxes.unbind(-1)
    flip_x = torch.stack([s - bx[2], bx[1], s - bx[0], bx[3]], -1)
    out_boxes = torch.where(do_lr[:, None, None], flip_x, out_boxes)
    bx = out_boxes.unbind(-1)
    flip_y = torch.stack([bx[0], s - bx[3], bx[2], s - bx[1]], -1)
    out_boxes = torch.where(do_ud[:, None, None], flip_y, out_boxes)

    # compaction: kept boxes first (stable), truncated to max_boxes
    order = torch.sort((~out_keep).to(torch.uint8), dim=1, stable=True).indices[:, :max_boxes]
    out_boxes = torch.gather(out_boxes, 1, order[..., None].expand(-1, -1, 4))
    out_cls = torch.gather(out_cls, 1, order)
    out_keep = torch.gather(out_keep, 1, order)
    return out_imgs, out_boxes * out_keep[..., None], out_cls * out_keep, out_keep


def augment_batch(images, hw, boxes, classes, mask, seed: int, imgsz: int,
                  cfg: DeviceAugConfig = DeviceAugConfig(), max_boxes: int = 128, dp=None):
    """Draw from a generator on the batch's device seeded with ``seed``,
    then ``apply``. With ``dp`` (a ``parallel.DataParallel``) the arrays
    are this rank's rows of the global raw batch: the ranks' rows are
    gathered, the draws are the global batch's, and this rank's rows come
    out."""
    rows = None
    if dp is not None:
        images, hw, boxes, classes, mask = dp.gather_rows((images, hw, boxes, classes, mask))
        rows = dp.rows(images.shape[0])
    gen = torch.Generator(device=images.device).manual_seed(int(seed))
    return apply(images, hw, boxes, classes, mask, draw(images.shape[0], gen, cfg, images.device),
                 imgsz, cfg, max_boxes, rows)

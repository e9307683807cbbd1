"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode, with numpy-made inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deal_yolo_daya_tpu.models import blocks as jax_blocks
from deal_yolo_daya_tpu.ops.pallas.area_attention import area_attention as jax_area_attention
from deal_yolo_daya_tpu.ops.pallas.nms_suppress import suppress as jax_suppress
from deal_yolo_daya_tpu.ops.pallas.score_reduce import score_reduce as jax_score_reduce
from deal_yolo_daya_tpu.ops.pallas.score_reduce import score_reduce_xla as jax_score_reduce_xla
from deal_yolo_daya_tpu_torch.models.blocks import PSAAttention
from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa_mod
from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as nms_mod
from deal_yolo_daya_tpu_torch.ops.kernels import score_reduce as sr_mod
from deal_yolo_daya_tpu_torch.ops.kernels.area_attention import area_attention
from deal_yolo_daya_tpu_torch.ops.kernels.nms_suppress import nms_suppress
from deal_yolo_daya_tpu_torch.ops.kernels.score_reduce import score_reduce
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401


# yolo11n's C2PSA widths at n = 35, one 80-row key tile of the CUDA kernels,
# one past it and the main shape's 400; yolo12's AAttn heads (key_dim =
# head_dim = 32) at n = 100 (a full key tile and a ragged one of 20, its
# 320 px shape) and n = 81 with 4 heads; and a narrow head
ATTN_SHAPES = [(2, 35, 2, 32, 64), (2, 80, 2, 32, 64), (2, 81, 2, 32, 64), (2, 400, 2, 32, 64),
               (8, 100, 2, 32, 32), (2, 81, 4, 32, 32), (3, 20, 1, 8, 16)]


@pytest.mark.parametrize("ba,n,heads,kd,hd", ATTN_SHAPES)
def test_area_attention_plain_matches_jax_kernel(ba, n, heads, kd, hd):
    rng = np.random.default_rng(0)
    qkv = rng.normal(0, 1, (ba, n, heads * (2 * kd + hd))).astype(np.float32)
    jout, jv = jax_area_attention(jnp.asarray(qkv), heads, hd, key_dim=kd, interpret=True)
    before = aa_mod.launches
    out, v = area_attention(torch.from_numpy(qkv), heads, hd, kd)
    assert aa_mod.launches == before  # the CPU takes the plain version
    # f32 on both sides; only the matmul summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_area_attention_plain_bf16_rounds_p_like_the_kernel():
    rng = np.random.default_rng(1)
    qkv = rng.normal(0, 1, (2, 35, 2 * 128)).astype(np.float32)
    jout, jv = jax_area_attention(jnp.asarray(qkv, jnp.bfloat16), 2, 64, key_dim=32,
                                  interpret=True)
    out, v = area_attention(torch.from_numpy(qkv).to(torch.bfloat16), 2, 64, 32)
    assert out.dtype == v.dtype == torch.bfloat16
    # both round P and the output to bf16; a rounding step may differ
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), atol=2e-2)
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(jv, np.float32))


def _bwd_inputs(seed, ba, n, heads, kd, hd):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (ba, n, heads * (2 * kd + hd))).astype(np.float32)
    d_out, d_v = rng.normal(0, 1, (2, ba, n, heads * hd)).astype(np.float32)
    return qkv, d_out, d_v


# bf16: both sides round P, dS and the result to bf16, from f32 sums taken in
# other orders, so an element may land a bf16 step (2^-8 relative) apart
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1.6e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ba,n,heads,kd,hd", ATTN_SHAPES)
def test_area_attention_bwd_plain_matches_jax_vjp(ba, n, heads, kd, hd, dtype):
    qkv, d_out, d_v = _bwd_inputs(3, ba, n, heads, kd, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda q: jax_area_attention(q, heads, hd, key_dim=kd, interpret=True),
                     jnp.asarray(qkv, jdt))
    (want,) = vjp((jnp.asarray(d_out, jdt), jnp.asarray(d_v, jdt)))
    before = aa_mod.bwd_launches
    got = aa_mod.area_attention_bwd_plain(torch.from_numpy(qkv).to(tdt),
                                          torch.from_numpy(d_out).to(tdt),
                                          torch.from_numpy(d_v).to(tdt), heads, hd, kd)
    assert aa_mod.bwd_launches == before
    assert got.dtype == tdt and got.shape == qkv.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_area_attention_function_grad_matches_autograd_of_plain(dtype):
    """On the CPU the autograd Function runs area_attention_bwd_plain; its
    gradient equals torch autograd through area_attention_plain."""
    qkv, d_out, d_v = (torch.from_numpy(a).to(dtype) for a in _bwd_inputs(4, 2, 35, 2, 32, 64))
    x = qkv.clone().requires_grad_()
    out, v = area_attention(x, 2, 64, 32)
    (got,) = torch.autograd.grad((out.float() * d_out.float()).sum()
                                 + (v.float() * d_v.float()).sum(), x)
    y = qkv.clone().requires_grad_()
    out, v = aa_mod.area_attention_plain(y, 2, 64, 32)
    (want,) = torch.autograd.grad((out.float() * d_out.float()).sum()
                                  + (v.float() * d_v.float()).sum(), y)
    tol = BWD_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)


def test_area_attention_output_is_differentiable():
    """The wrapper's outputs come from the autograd Function, so a backward
    reaches qkv (and everything before it) through the kernel path."""
    x = torch.randn(1, 9, 128, requires_grad=True)
    out, v = area_attention(x, 1, 64, 32)
    assert type(out.grad_fn).__name__ == type(v.grad_fn).__name__ == "AreaAttentionBackward"
    out.sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


def test_area_attention_grad_through_one_output():
    """An output that reaches no loss has no cotangent: it counts as zeros."""
    qkv, d_out, _ = _bwd_inputs(5, 2, 12, 2, 32, 64)
    x = torch.from_numpy(qkv).requires_grad_()
    out, _ = area_attention(x, 2, 64, 32)
    (out * torch.from_numpy(d_out)).sum().backward()
    want = aa_mod.area_attention_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(d_out),
                                           torch.zeros_like(torch.from_numpy(d_out)), 2, 64, 32)
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert float(x.grad[..., 64:128].abs().max()) > 0  # v gets its gradient through out


def test_psa_attention_gradients_match_jax():
    """PSAAttention's input and weight gradients through the port's Function
    against jax.grad through the Pallas kernel's custom VJP (interpret mode)."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 5, 7, 128)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    mod = jax_blocks.PSAAttention(128, 2, attn_ratio=0.5)
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    saved = jax_blocks.AATTN_PALLAS
    jax_blocks.AATTN_PALLAS = True
    try:
        jgx, jgp = jax.grad(lambda xx, p: jnp.sum(mod.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, xx) * w), argnums=(0, 1))(
                jnp.asarray(x), variables["params"])
    finally:
        jax_blocks.AATTN_PALLAS = saved
    port = PSAAttention(128, 2, attn_ratio=0.5).eval()
    port.load_state_dict(_psa_state_dict(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    (port(xt) * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-4)
    want = _psa_state_dict({"params": jgp, "batch_stats": {}})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want[name].abs().max()), err_msg=name)


def _psa_state_dict(tree):
    """JAX PSAAttention params/batch_stats -> the port module's state dict."""
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
    sd = {}
    for coll in ("params", "batch_stats"):
        for mod, parts in tree[coll].items():
            for part, leaves in parts.items():
                for name, arr in leaves.items():
                    a = np.array(arr, np.float32)
                    if name == "kernel":
                        a = a.transpose(3, 2, 0, 1)
                    sd[f"{mod}.{part}.{leaf[name]}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def test_psa_attention_matches_jax_with_pallas_kernel():
    # (2, 5, 7, 128): n = 35 tokens, 2 heads, head_dim 64, key_dim 32
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, 7, 128)).astype(np.float32)
    mod = jax_blocks.PSAAttention(128, 2, attn_ratio=0.5)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if a.ndim == 1 else a, variables)  # non-trivial BN
    saved = jax_blocks.AATTN_PALLAS
    jax_blocks.AATTN_PALLAS = True  # runs the Pallas kernel in interpret mode
    try:
        want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    finally:
        jax_blocks.AATTN_PALLAS = saved
    port = PSAAttention(128, 2, attn_ratio=0.5)
    port.load_state_dict(_psa_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4)


def _candidates(seed=7, b=2, a=256, nc=3, conf=0.3, k=128):
    """The dense scene of tests/test_ops.py's Pallas-suppress parity test,
    reduced to score-sorted, class-offset candidates as ops/nms.py does."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(20, 200, (b, a)), rng.uniform(20, 200, (b, a))
    w, h = rng.uniform(4, 60, (b, a)), rng.uniform(4, 60, (b, a))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, a, nc)).astype(np.float32)
    best, cls = scores.max(-1), scores.argmax(-1)
    masked = np.where(best >= np.float32(conf), best, np.float32(-1))
    order = np.argsort(-masked, axis=1, kind="stable")[:, :k]
    cand = np.take_along_axis(boxes, order[..., None], 1)
    cand_cls = np.take_along_axis(cls, order, 1)
    offset = cand + cand_cls[..., None].astype(np.float32) * np.float32(7680.0)
    valid = np.take_along_axis(masked, order, 1) > 0
    return offset.astype(np.float32), valid


@pytest.mark.parametrize("iou", [0.45, 0.7])
def test_suppress_plain_bit_exact_with_jax_kernel(iou):
    boxes, valid = _candidates()
    before = nms_mod.launches
    keep = nms_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), iou)
    assert nms_mod.launches == before  # the CPU takes the plain version
    assert keep.dtype == torch.bool and keep.shape == valid.shape
    for i in range(len(boxes)):
        want = np.asarray(jax_suppress(jnp.asarray(boxes[i]), jnp.asarray(valid[i], jnp.float32),
                                       iou, interpret=True)) > 0
        np.testing.assert_array_equal(keep[i].numpy(), want)
    assert 0 < int(keep.sum()) < int(valid.sum())  # cascades and suppressions both occur


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100])
@pytest.mark.parametrize("iou", [0.0, 0.45, 0.7])
def test_suppress_plain_bit_exact_with_jax_kernel_at_edges(k, iou):
    """Ragged K around a 32-bit word, iou 0 (any overlap suppresses), and
    invalid candidates scattered among the valid ones."""
    boxes, valid = _candidates(seed=k, k=k)
    valid &= np.random.default_rng(k + 1).random(valid.shape) > 0.2
    keep = nms_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), iou)
    for i in range(len(boxes)):
        want = np.asarray(jax_suppress(jnp.asarray(boxes[i]), jnp.asarray(valid[i], jnp.float32),
                                       iou, interpret=True)) > 0
        np.testing.assert_array_equal(keep[i].numpy(), want)
    assert not (keep.numpy() & ~valid).any()


def _mask_units(words, cluster, first, warps=32):
    """The CUDA kernel's deal of bitmask units (row tile, word >= tile) to the
    computing warps of a cluster (the peers' and, with first 0, rank 0's off
    the walker's scheduler, warp % 4 != 0), decoded as the kernel decodes it."""
    units = words * (words + 1) // 2
    own = 0 if first else warps - warps // 4
    stride = own + (cluster - 1) * warps
    seen = []
    for rank in range(first, cluster):
        for warp in range(warps):
            slot = (warp - warp // 4 - 1 if warp % 4 else -1) if rank == 0 else \
                own + (rank - 1) * warps + warp
            if slot < 0:
                continue
            rt, rest = 0, slot
            u = rest
            while u < units:
                while rest >= words - rt:
                    rest -= words - rt
                    rt += 1
                seen.append((rt, rt + rest))
                u += stride
                rest += stride
    return seen


@pytest.mark.parametrize("words,cluster,first", [(1, 8, 0), (2, 2, 1), (32, 4, 0), (42, 8, 1),
                                                 (42, 2, 1), (33, 1, 0)])
def test_nms_mask_units_cover_the_upper_triangle_once(words, cluster, first):
    seen = _mask_units(words, cluster, first)
    assert sorted(seen) == [(rt, w) for rt in range(words) for w in range(rt, words)]


def _walk_model(sup: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The CUDA kernel's walk in numpy: the column-major bitmask (word w of
    row i), then word by word the 32-step greedy chain and the kept rows'
    removals ORed into each later word column."""
    k = len(valid)
    words = (k + 31) // 32
    bits = [[0] * k for _ in range(words)]
    for i, c in zip(*np.nonzero(np.triu(sup, 1))):
        bits[c // 32][i] |= 1 << (c % 32)
    removed = [0] * words
    keep = np.zeros(k, bool)
    for w in range(words):
        rows = range(32 * w, min(k, 32 * w + 32))
        avail = sum(1 << (r - 32 * w) for r in rows if valid[r]) & ~removed[w]
        kept = 0
        for t, r in enumerate(rows):  # the chain within the word
            if (avail >> t) & 1:
                kept |= 1 << t
                avail &= ~bits[w][r]
        for t, r in enumerate(rows):
            keep[r] = bool((kept >> t) & 1)
        for c in range(w + 1, words):  # one OR-reduction a later column
            for t, r in enumerate(rows):
                if (kept >> t) & 1:
                    removed[c] |= bits[c][r]
    return keep


@pytest.mark.parametrize("seed,k,iou", [(0, 1, 0.5), (1, 33, 0.3), (2, 100, 0.0), (3, 100, 0.6),
                                        (4, 300, 0.45), (5, 300, 0.7)])
def test_nms_walk_model_matches_plain_on_dense_scenes(seed, k, iou):
    """The kernel's word-wise walk (a chain a word, then column ORs) reaches
    the plain version's greedy fixed point on dense, overlapping scenes."""
    from deal_yolo_daya_tpu_torch.ops.boxes import bbox_iou

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 150, (k, 2))
    wh = rng.uniform(10, 80, (k, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32)
    valid = rng.random(k) > 0.1
    iou_m = bbox_iou(boxes[:, None, :], boxes[None, :, :])
    sup = ((iou_m > torch.tensor(iou, dtype=torch.float32)).numpy() & valid[:, None]
           & valid[None, :])
    want = nms_mod.nms_suppress_plain(boxes[None], torch.from_numpy(valid)[None], iou)[0]
    np.testing.assert_array_equal(_walk_model(sup, valid), want.numpy())
    if k >= 100:
        assert 0 < want.sum() < valid.sum()


def _reach(boxes: np.ndarray, thr: float) -> np.ndarray:
    """csrc/nms_suppress.cu::reach_box in f32 numpy: (center x, center y,
    reach x, reach y), a non-finite box reaching everywhere."""
    f = np.float32
    x1, y1, x2, y2 = (boxes[:, i].astype(np.float32) for i in range(4))
    scale = np.maximum(f(1) - f(thr), f(0)) + f(1e-5)
    cx, hx = f(0.5) * x1 + f(0.5) * x2, f(0.5) * x2 - f(0.5) * x1
    cy, hy = f(0.5) * y1 + f(0.5) * y2, f(0.5) * y2 - f(0.5) * y1
    gx = scale * hx + f(1e-5) * (np.abs(cx) + np.abs(hx)) + f(1e-30)
    gy = scale * hy + f(1e-5) * (np.abs(cy) + np.abs(hy)) + f(1e-30)
    out = np.stack([cx, cy, gx, gy], -1)
    bad = ~np.isfinite(boxes).all(-1)
    out[bad] = (0, 0, np.inf, np.inf)
    return out


def _adversarial_pairs(rng, thr: float, n: int) -> np.ndarray:
    """Box pairs at IoU within a few ulps of thr (shifted, nested, both axes),
    at scales from 1e-3 to 1e4 px and class offsets up to 79 * 7680, plus
    identical, touching, degenerate and non-finite boxes -> (2n + 8, 4)."""
    t = np.float64(thr)
    out = []
    for _ in range(n):
        w, h = rng.uniform(0.5, 2.0, 2) * 10.0 ** rng.uniform(-3, 4)
        x0, y0 = rng.uniform(0, 640, 2) + 7680.0 * rng.integers(0, 80)
        kind = rng.integers(0, 3)
        if kind == 0:    # shifted along x: IoU = (w - d) / (w + d)
            d = w * (1 - t) / (1 + t) * (1 + rng.normal(0, 1e-6))
            b = (x0 + d, y0, x0 + d + w, y0 + h)
        elif kind == 1:  # nested, area ratio t
            s = np.sqrt(t) * (1 + rng.normal(0, 1e-6))
            b = (x0 + (1 - s) * w / 2, y0 + (1 - s) * h / 2, x0 + (1 + s) * w / 2,
                 y0 + (1 + s) * h / 2)
        else:            # shifted along both axes by the same share
            g = np.sqrt(t) * (1 + rng.normal(0, 1e-6))
            d = (1 - g) / (1 + g)
            b = (x0 + d * w, y0 + d * h, x0 + (1 + d) * w, y0 + (1 + d) * h)
        out += [(x0, y0, x0 + w, y0 + h), b]
    out += [(0, 0, 10, 10), (0, 0, 10, 10), (10, 0, 20, 10), (5, 5, 5, 9),
            (np.nan, 0, 10, 10), (0, 0, np.inf, 10), (-np.inf, -np.inf, np.inf, np.inf),
            (3, 3, 7, 7)]
    return np.asarray(out, np.float64).astype(np.float32)


@pytest.mark.parametrize("thr", [0.0, 0.3, 0.45, 0.5, 0.7, 0.9, 1.0])
def test_nms_reach_test_keeps_every_suppressing_pair(thr):
    """The kernel's necessary test (|center difference| < summed reach on
    both axes) passes every pair whose exact f32 IoU exceeds thr, over
    adversarial near-threshold pairs and random dense scenes, so it drops
    only pairs whose bit is 0; at thr 0.7 it also drops most overlaps."""
    from deal_yolo_daya_tpu_torch.ops.boxes import bbox_iou

    def hits_and_candidates(boxes):
        t = torch.from_numpy(boxes)
        with np.errstate(invalid="ignore"):
            hit = (bbox_iou(t[:, None], t[None]) > torch.tensor(thr, dtype=torch.float32)).numpy()
            r = _reach(boxes, thr)
            cand = ((np.abs(r[:, None, 0] - r[None, :, 0]) < r[:, None, 2] + r[None, :, 2])
                    & (np.abs(r[:, None, 1] - r[None, :, 1]) < r[:, None, 3] + r[None, :, 3]))
        assert not (hit & ~cand).any(), np.argwhere(hit & ~cand)[:5]
        return hit, cand

    rng = np.random.default_rng(int(thr * 100))
    hit, _ = hits_and_candidates(_adversarial_pairs(rng, thr, 400))
    if 0 < thr < 1:  # the pairs straddle the threshold (at 0 they round to touching)
        assert 0.05 < hit[np.arange(0, 800, 2), np.arange(1, 800, 2)].mean() < 0.95
    xy = rng.uniform(0, 600, (600, 2))
    scene = np.concatenate([xy, xy + rng.uniform(8, 200, (600, 2))], -1).astype(np.float32)
    _, cand = hits_and_candidates(scene)
    if thr == 0.7:
        meet = ((np.minimum(scene[:, None, 2], scene[None, :, 2])
                 > np.maximum(scene[:, None, 0], scene[None, :, 0]))
                & (np.minimum(scene[:, None, 3], scene[None, :, 3])
                   > np.maximum(scene[:, None, 1], scene[None, :, 1])))
        assert cand.sum() < meet.sum() / 5


@pytest.mark.parametrize("b", [1, 2, 3, 16, 32, 33, 66, 132])
def test_nms_geometry_accepts_every_k_to_the_limit(b):
    """Every K <= 1344 takes the cluster mapping and fits a CTA's shared
    memory, and B clusters fill at most the card's 132 SMs and all run at
    once where the card holds them (the H100 SXM's measured counts, passed
    explicitly); K = 1345 and 4096 take the global-memory mapping; K < 1
    raises as the wrapper does."""
    active = nms_mod.ACTIVE_CLUSTERS
    assert nms_mod.MAX_K == 1344
    for k in range(1, nms_mod.MAX_K + 1):
        g = nms_mod.nms_geometry(b, k, active)
        assert not g.in_global and g.blocks == 0
        assert g.first in (0, 1) and g.first < g.cluster <= nms_mod.MAX_CLUSTER
        assert g.smem <= nms_mod.SMEM_LIMIT and g.smem >= nms_mod.walker_bytes(k)
        held = 16 * (k + nms_mod.PAD) + nms_mod.SCRATCH_BYTES  # staged boxes, warps' words
        if g.first == 0:  # the walker holds the boxes too, 16-byte aligned
            assert g.smem >= (nms_mod.walker_bytes(k) + 15) // 16 * 16 + held
        else:
            assert g.smem >= held + k
        assert b * g.cluster <= nms_mod.SMS or b > nms_mod.SMS // (g.first + 1)
        # every cluster runs at once wherever the card holds B of the smallest
        if b <= active[g.first + 1]:
            assert b <= active[g.cluster]
    for k in (nms_mod.MAX_K + 1, 4096):
        g = nms_mod.nms_geometry(b, k, active)
        words = (k + 31) // 32
        assert g.in_global and g.smem == 4 * words  # the walking warp's kept words
        # mask CTAs: at least one an image, no more than the units fill
        assert 1 <= g.blocks <= -(-words * (words + 1) // 2 // (nms_mod.G_THREADS // 32))
        assert nms_mod.bitmask_words(b, k) == b * k * words
    with pytest.raises(ValueError, match="at least 1"):
        nms_mod.nms_geometry(b, 0, active)
    assert nms_mod.nms_geometry(32, 1000, active) == (3, 0, 150128, 0)  # predict's: 96 CTAs
    # a card that holds fewer clusters gets smaller ones
    assert nms_mod.nms_geometry(32, 1000, (0, 132, 66, 31, 20, 0, 0, 0, 0)).cluster == 2


def test_nms_global_walk_model_matches_plain_beyond_the_limit():
    """The global mapping deals the same units over its CTAs' warps (every
    unit of K = 1400 once) and walks the same column-major words, so the
    walk model gives the plain version's keep mask there too."""
    from deal_yolo_daya_tpu_torch.ops.boxes import bbox_iou

    k = nms_mod.MAX_K + 56
    g = nms_mod.nms_geometry(2, k, nms_mod.ACTIVE_CLUSTERS)
    words, warps = (k + 31) // 32, nms_mod.G_THREADS // 32
    units = words * (words + 1) // 2
    seen = []
    for slot in range(g.blocks * warps):  # the kernel's decode of its units
        rt, rest, u = 0, slot, slot
        while u < units:
            while rest >= words - rt:
                rest -= words - rt
                rt += 1
            seen.append((rt, rt + rest))
            u += g.blocks * warps
            rest += g.blocks * warps
    assert sorted(seen) == [(rt, w) for rt in range(words) for w in range(rt, words)]
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 900, (k, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + rng.uniform(10, 120, (k, 2))], -1),
                         dtype=torch.float32)
    valid = rng.random(k) > 0.1
    sup = ((bbox_iou(boxes[:, None, :], boxes[None, :, :]) > torch.tensor(0.5)).numpy()
           & valid[:, None] & valid[None, :])
    want = nms_mod.nms_suppress_plain(boxes[None], torch.from_numpy(valid)[None], 0.5)[0]
    np.testing.assert_array_equal(_walk_model(sup, valid), want.numpy())
    assert 0 < want.sum() < valid.sum()


# ---------------------------------------------------------------- score_reduce
# The cases of tests/test_pallas_kernels.py: scores within 1e-6 of the TPU
# kernel's interpret mode and of score_reduce_xla (the same f32 sigmoid of the
# same max; XLA's and PyTorch's sigmoid may differ in an ulp), classes exact.


def _score_reduce_both(x: np.ndarray):
    before = sr_mod.launches
    got = score_reduce(torch.from_numpy(x) if x.dtype != jnp.bfloat16
                       else torch.from_numpy(x.astype(np.float32)).bfloat16())
    assert sr_mod.launches == before  # the CPU takes the plain version
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    xj = jnp.asarray(x)
    return [t.numpy() for t in got], [np.asarray(a) for a in jax_score_reduce(xj, interpret=True)], \
        [np.asarray(a) for a in jax_score_reduce_xla(xj)]


@pytest.mark.parametrize("shape", [(2, 1024, 80), (1, 100, 3), (3, 8400, 80)])
def test_score_reduce_plain_matches_jax_kernel(shape):
    x = np.asarray(jnp.asarray(np.random.default_rng(0).normal(-3, 2, shape), jnp.bfloat16))
    (s, c), (ks, kc), (xs, xc) = _score_reduce_both(x)
    np.testing.assert_allclose(s, ks, atol=1e-6)
    np.testing.assert_allclose(s, xs, atol=1e-6)
    np.testing.assert_array_equal(c, kc)
    np.testing.assert_array_equal(c, xc)


def test_score_reduce_ties_go_to_the_lowest_class():
    x = np.full((1, 8, 5), -2.0, np.float32)
    x[0, 0, [1, 3]] = 1.0
    x[0, 1, [0, 4]] = 0.5
    x[0, 2, :] = -np.inf  # a row with no finite logit: class 0, score 0
    (s, c), (ks, kc), _ = _score_reduce_both(x)
    assert c[0, :3].tolist() == [1, 0, 0] and kc[0, :2].tolist() == [1, 0]
    assert s[0, 2] == 0.0
    np.testing.assert_allclose(s[0, 0], 1 / (1 + np.exp(-1.0)), atol=1e-6)
    np.testing.assert_allclose(s[0, :2], ks[0, :2], atol=1e-6)


def test_score_reduce_f32_input_and_strided_view():
    """f32 logits, and the transposed (B, nc, A) -> (B, A, nc) view that
    flatten_levels hands over: the wrapper reads strides, no copy needed."""
    x = np.random.default_rng(1).normal(0, 1, (2, 300, 7)).astype(np.float32)
    (s, c), (ks, kc), (xs, xc) = _score_reduce_both(x)
    np.testing.assert_allclose(s, ks, atol=1e-6)
    np.testing.assert_allclose(s, xs, atol=1e-6)
    np.testing.assert_array_equal(c, kc)
    np.testing.assert_array_equal(c, xc)
    view = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    assert not view.is_contiguous()
    vs, vc = score_reduce(view)
    np.testing.assert_array_equal(vs.numpy(), s)
    np.testing.assert_array_equal(vc.numpy(), c)


def _layouts(x: torch.Tensor):
    """x contiguous, a view one element off its storage's start, and the
    anchor-contiguous view of the same values."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.flatten()
    return {"contiguous": x, "offset by one": flat[1:].view(x.shape),
            "anchors contiguous": x.transpose(1, 2).contiguous().transpose(1, 2)}


@pytest.mark.parametrize("nc", [1, 8, 37, 80, 81])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_score_reduce_mapping_follows_the_layout(nc, dtype):
    """bulk_rows exactly where back-to-back rows are whole 16-byte vectors
    from a 16-byte boundary, warp_rows for other class-contiguous rows,
    anchors for other strides; the plain version gives the same values in
    every layout."""
    x = torch.from_numpy(np.random.default_rng(nc).normal(0, 2, (2, 64, nc)).astype(np.float32))
    x = x.to(dtype)
    want = sr_mod.score_reduce_plain(x)
    esize = 2 if dtype == torch.bfloat16 else 4
    rows = "bulk_rows" if nc * esize % 16 == 0 else "warp_rows"
    # at nc 1 the transposed copy is the same layout (a size-1 dim's stride is free)
    expect = {"contiguous": rows, "offset by one": "warp_rows",
              "anchors contiguous": "anchors" if nc > 1 else rows}
    for name, view in _layouts(x).items():
        got = sr_mod.reduce_mapping(view.dtype, view.shape, view.stride(), view.data_ptr())
        assert got == expect[name], name
        s, c = score_reduce(view)
        assert torch.equal(s, want[0]) and torch.equal(c, want[1])


def test_kernel_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        area_attention(torch.empty((1, 4, 128), device="meta"), 1, 64, 32)
    with pytest.raises(ValueError, match="no kernel"):
        nms_suppress(torch.empty((1, 4, 4), device="meta"),
                     torch.empty((1, 4), dtype=torch.bool, device="meta"), 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        score_reduce(torch.empty((1, 4, 80), device="meta"))


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh gives every source a new library path, so a
    kernel never loads a library built against an older header."""
    from deal_yolo_daya_tpu_torch.ops.kernels import _build

    (tmp_path / "area_attention.cu").write_text('#include "hopper.cuh"\n')
    header = tmp_path / "hopper.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("area_attention")
    assert _build.library_path("area_attention") == before
    header.write_text("// two\n")
    assert _build.library_path("area_attention") != before


def test_build_function_sets_argument_types_once(monkeypatch):
    """The wrappers' C functions get argtypes and restype when first asked
    for; later calls return the same configured function."""
    import ctypes
    import types

    from deal_yolo_daya_tpu_torch.ops.kernels import _build

    loads = []

    def fake_load(name):
        loads.append(name)
        return types.SimpleNamespace(entry=types.SimpleNamespace())

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_FUNCS", {})
    fn = _build.function("area_attention", "entry", aa_mod._FWD_ARGS)
    assert fn.argtypes == aa_mod._FWD_ARGS and fn.restype is ctypes.c_int
    fn.argtypes = None  # a second ask must not set them again
    assert _build.function("area_attention", "entry", aa_mod._FWD_ARGS) is fn
    assert fn.argtypes is None and loads == ["area_attention"]

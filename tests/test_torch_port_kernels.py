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
from deal_yolo_daya_tpu_torch.models.blocks import PSAAttention
from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa_mod
from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as nms_mod
from deal_yolo_daya_tpu_torch.ops.kernels.area_attention import area_attention
from deal_yolo_daya_tpu_torch.ops.kernels.nms_suppress import nms_suppress


@pytest.mark.parametrize("ba,n,heads,kd,hd", [(2, 35, 2, 32, 64), (3, 20, 1, 8, 16)])
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


def test_kernel_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        area_attention(torch.empty((1, 4, 128), device="meta"), 1, 64, 32)
    with pytest.raises(ValueError, match="no kernel"):
        nms_suppress(torch.empty((1, 4, 4), device="meta"),
                     torch.empty((1, 4), dtype=torch.bool, device="meta"), 0.5)

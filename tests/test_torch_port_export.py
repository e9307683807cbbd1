"""``export_stablehlo``/``load_stablehlo`` of the port (a ``torch.export``
program) on the CPU: the portable artifact against the port's eager program
and against the JAX package's StableHLO artifact, NMS with runtime 0-dim
thresholds against JAX's ``batched_nms`` (XLA and the Pallas kernel in
interpret mode), a torch-only process running the artifact, the refusals
of ``use_pallas=True``, and the two custom ops under ``torch.library.opcheck``.
yolo11n, nc 2, 64 px, f32, weights carried over from a JAX tree."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deal_yolo_daya_tpu.api import YOLO as JaxYOLO
from deal_yolo_daya_tpu.models import build_yolo11 as jax_build_yolo11
from deal_yolo_daya_tpu.ops.nms import batched_nms as jax_batched_nms
from deal_yolo_daya_tpu_torch.api import ServeProgram, YOLO
from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.models.yolo11 import fuse_conv_bn
from deal_yolo_daya_tpu_torch.ops.kernels import nms_suppress as nms_mod
from deal_yolo_daya_tpu_torch.ops.nms import batched_nms

REPO = Path(__file__).resolve().parents[1]
IMGSZ, NC, MAX_DET = 64, 2, 16
# the port's artifact against JAX's on the same weights and u8 batch: both
# divide in bf16 (the bf16 step of x / 255) and run the network in f32, so
# detections (the same counts and classes) differ by the f32 rounding of
# ~100 convs summed in another order, which the loud test heads (boxes up to
# 430 px) amplify: up to 5.8e-3 px and 1.9e-5 in score over four batches;
# the bars are test_torch_port_model.py's predict bars, with a margin
JAX_BOX_ATOL, JAX_SCORE_ATOL = 2e-2, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two CPU threads: the suite runs several workers side by side."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _perturb(tree, rng, path=()):
    """Random BN statistics and louder head outputs, so that random-init
    outputs are not degenerate; class biases 0 so that conf 0.25 leaves NMS
    real work (as tests/test_torch_port_model.py)."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if hasattr(v, "items"):
            out[k] = _perturb(v, rng, p)
            continue
        a = np.array(v, np.float32)
        if "bn" in p:
            lo, hi = {"scale": (0.8, 1.6), "bias": (-0.3, 0.3),
                      "mean": (-0.2, 0.2), "var": (0.5, 1.5)}[k]
            a = rng.uniform(lo, hi, a.shape).astype(np.float32)
        elif p[0] == "detect" and p[-2] in ("box0_2", "box1_2", "box2_2") and k == "kernel":
            a = a * 15.0
        elif p[0] == "detect" and p[-2] in ("cls0_2", "cls1_2", "cls2_2"):
            a = a * 10.0 if k == "kernel" else np.zeros_like(a)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def jax_model():
    model, variables = jax_build_yolo11("n", nc=NC, imgsz=IMGSZ, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    return model, {c: _perturb(variables[c], rng) for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def handle(jax_model):
    yolo = YOLO("yolo11n", nc=NC, imgsz=IMGSZ, device="cpu", dtype=torch.float32)
    yolo._ensure_built().load_state_dict(state_dict_from_jax(jax_model[1]), strict=True)
    yolo.names = ["猫", "dog"]
    return yolo


@pytest.fixture(scope="module")
def bundle(handle, tmp_path_factory):
    """The portable artifact, symbolic batch."""
    return handle.export_stablehlo(tmp_path_factory.mktemp("shlo") / "sym", max_det=MAX_DET)


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, IMGSZ, IMGSZ, 3), dtype=np.uint8)


def _eager(handle, images, conf, iou):
    program = ServeProgram(fuse_conv_bn(handle._ensure_built()).eval(), IMGSZ, torch.float32,
                           MAX_DET)
    with torch.no_grad():
        return program(torch.from_numpy(images), torch.tensor(conf), torch.tensor(iou))


def test_portable_round_trip_equals_the_eager_program(handle, bundle):
    assert (bundle / "model.pt2").exists()
    fn, meta = YOLO.load_stablehlo(bundle, device="cpu")
    assert meta["platforms"] == ["cpu", "cuda"] and meta["batch_size"] is None
    assert meta["names"] == ["猫", "dog"] and meta["max_det"] == MAX_DET
    ops = {str(n.target) for n in torch.export.load(str(bundle / "model.pt2")).graph.nodes
           if n.op == "call_function"}
    assert not any("dyd" in op for op in ops)  # only aten ops and the while_loop
    assert any("while_loop" in op for op in ops)
    for bs in (1, 3):  # one artifact, any batch
        images = _images(bs, bs)
        got = fn(images, 0.001, 0.7)
        assert [tuple(t.shape) for t in got] == [(bs, MAX_DET, 4), (bs, MAX_DET), (bs, MAX_DET),
                                                (bs,)]
        assert [t.dtype for t in got] == [torch.float32, torch.float32, torch.int32, torch.int32]
        for g, w in zip(got, _eager(handle, images, 0.001, 0.7)):
            assert torch.equal(g, w)  # the same program, exactly
    images = _images(5, 3)
    n_low = int(fn(images, 0.001, 0.7)[3].sum())
    assert int(fn(images, 0.9, 0.7)[3].sum()) <= n_low and n_low > 0
    # iou is a runtime input too: one artifact, each threshold as eager at it
    for iou in (0.3, 0.45, 0.7):
        got = fn(images, 0.25, torch.tensor(iou))
        for g, w in zip(got, _eager(handle, images, 0.25, iou)):
            assert torch.equal(g, w)
    assert int(fn(images, 0.25, 0.3)[3].sum()) <= int(fn(images, 0.25, 0.7)[3].sum())


def test_portable_artifact_matches_the_jax_export(jax_model, handle, bundle, tmp_path):
    jyolo = JaxYOLO("yolo11n", nc=NC, imgsz=IMGSZ)
    jyolo._model, jyolo._variables = jax_model
    jyolo.names = ["猫", "dog"]
    jfn, jmeta = JaxYOLO.load_stablehlo(jyolo.export_stablehlo(tmp_path / "jax",
                                                               max_det=MAX_DET))
    fn, meta = YOLO.load_stablehlo(bundle, device="cpu")
    assert jmeta["platforms"] == ["cpu", "tpu"]
    assert {k: v for k, v in meta.items() if k != "platforms"} == \
        {k: v for k, v in jmeta.items() if k != "platforms"}
    images = _images(3, 3)
    want = [np.asarray(t) for t in jfn(jnp.asarray(images), jnp.float32(0.25),
                                       jnp.float32(0.7))]
    got = [t.numpy() for t in fn(images, 0.25, 0.7)]
    np.testing.assert_array_equal(got[3], want[3])
    assert int(want[3].sum()) > 10  # NMS had real work
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=JAX_BOX_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=JAX_SCORE_ATOL, rtol=0)


def _planted_scene(seed, thr, pairs=48, extra=64, nc=3):
    """(2, A, 4) boxes and (2, A, nc) scores: pairs of one class whose f64 IoU
    lies within a few parts in 1e6 of thr (shifted, nested and shifted on
    both axes, as tests/test_torch_port_kernels.py's adversarial pairs), the
    higher score on either box, among random boxes."""
    rng = np.random.default_rng(seed)
    t = float(thr)
    boxes, scores = [], []
    for _ in range(2):
        bx, sc = [], []
        for _ in range(pairs):
            w, h = rng.uniform(8, 120, 2)
            x0, y0 = rng.uniform(0, 500, 2)
            kind = rng.integers(0, 3)
            if kind == 0:
                d = w * (1 - t) / (1 + t) * (1 + rng.normal(0, 1e-6))
                b = (x0 + d, y0, x0 + d + w, y0 + h)
            elif kind == 1:
                s = np.sqrt(t) * (1 + rng.normal(0, 1e-6))
                b = (x0 + (1 - s) * w / 2, y0 + (1 - s) * h / 2, x0 + (1 + s) * w / 2,
                     y0 + (1 + s) * h / 2)
            else:
                g = np.sqrt(t) * (1 + rng.normal(0, 1e-6))
                d = (1 - g) / (1 + g)
                b = (x0 + d * w, y0 + d * h, x0 + (1 + d) * w, y0 + (1 + d) * h)
            bx += [(x0, y0, x0 + w, y0 + h), b]
            cls = rng.integers(0, nc)
            for _ in range(2):
                row = rng.uniform(0, 0.2, nc)
                row[cls] = rng.uniform(0.3, 1.0)
                sc.append(row)
        for _ in range(extra):
            x0, y0 = rng.uniform(0, 500, 2)
            w, h = rng.uniform(4, 80, 2)
            bx.append((x0, y0, x0 + w, y0 + h))
            sc.append(rng.uniform(0, 1, nc))
        boxes.append(bx)
        scores.append(sc)
    return np.asarray(boxes).astype(np.float32), np.asarray(scores).astype(np.float32)


def _loop_suppression(boxes, valid, thr):
    """The plain suppression's Jacobi solve as a host loop (the form it had
    before ``while_loop``): the reference the op-traceable one must equal."""
    from deal_yolo_daya_tpu_torch.ops.boxes import bbox_iou

    k = boxes.shape[1]
    before = torch.ones((k, k), dtype=torch.bool).triu(1)
    iou = bbox_iou(boxes[:, :, None, :], boxes[:, None, :, :])
    sup = (iou > torch.tensor(thr, dtype=torch.float32)) & before & valid[:, :, None] \
        & valid[:, None, :]
    prev, keep = valid, valid & ~sup.any(1)
    for _ in range(k):
        if torch.equal(keep, prev):
            break
        prev, keep = keep, valid & ~(sup & keep[:, :, None]).any(1)
    return keep


@pytest.mark.parametrize("thr", [0.3, 0.45, 0.7])
def test_nms_with_tensor_thresholds_equals_jax_bit_for_bit(thr):
    """0-dim f32 conf and iou (an exported program's runtime inputs) on
    planted near-threshold pairs: every output equals JAX's batched_nms on
    its XLA path and through the Pallas kernel (interpret mode); the
    suppression equals the host loop's with a float and a tensor threshold."""
    boxes, scores = _planted_scene(int(thr * 100), thr)
    conf = np.float32(0.25)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      conf_thres=torch.tensor(conf), iou_thres=torch.tensor(np.float32(thr)),
                      pre_topk=200, max_det=100)
    for use_pallas in (False, True):
        want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.float32(conf),
                               jnp.float32(thr), pre_topk=200, max_det=100,
                               use_pallas=use_pallas)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[3].min())
    # the suppression alone, on the candidates batched_nms builds from them
    b = torch.from_numpy(boxes) + torch.from_numpy(scores).argmax(-1)[..., None] * 7680.0
    valid = torch.from_numpy(scores.max(-1) >= conf)
    order = torch.sort(torch.where(valid, torch.from_numpy(scores.max(-1)), -1.0), dim=1,
                       descending=True, stable=True).indices
    cand = b.gather(1, order[..., None].expand(-1, -1, 4)).contiguous()
    cand_valid = valid.gather(1, order).contiguous()
    want = _loop_suppression(cand, cand_valid, thr)
    assert 0 < int(want.sum()) < int(cand_valid.sum())
    for t in (thr, torch.tensor(thr, dtype=torch.float32)):
        assert torch.equal(nms_mod.nms_suppress_plain(cand, cand_valid, t), want)


CHILD = """
import json, sys
import numpy as np
import torch
from torch.export.passes import move_to_device_pass
ep = move_to_device_pass(torch.export.load(sys.argv[1]), "cpu")
images = torch.from_numpy(np.load(sys.argv[2]))
out = ep.module()(images, torch.tensor(0.25), torch.tensor(0.7))
torch.save([t.clone() for t in out], sys.argv[3])
print(json.dumps(sorted(m for m in sys.modules if m.startswith("deal_yolo"))))
"""


def test_a_torch_only_process_runs_the_portable_artifact(handle, bundle, tmp_path):
    images = _images(9, 2)
    np.save(tmp_path / "images.npy", images)
    out = subprocess.run([sys.executable, "-c", CHILD, str(bundle / "model.pt2"),
                          str(tmp_path / "images.npy"), str(tmp_path / "out.pt")],
                         cwd=tmp_path, check=True, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    got = torch.load(tmp_path / "out.pt")
    for g, w in zip(got, _eager(handle, images, 0.25, 0.7)):
        assert torch.equal(g, w)


def test_use_pallas_refuses_without_a_card_or_a_batch_size(handle, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="use_pallas"):
        handle.export_stablehlo(tmp_path / "a", batch_size=2, use_pallas=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="use_pallas"):
        handle.export_stablehlo(tmp_path / "b", use_pallas=True)
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ba,n,heads,kd,hd", [(3, 40, 2, 32, 64), (4, 25, 4, 32, 32)])
def test_attention_op_passes_opcheck(ba, n, heads, kd, hd, dtype):
    qkv = torch.randn((ba, n, heads * (2 * kd + hd)),
                      generator=torch.Generator().manual_seed(n)).to(dtype)
    torch.library.opcheck(torch.ops.dyd.area_attention_fwd.default, (qkv, heads, hd, kd))


@pytest.mark.parametrize("k", [1, 33, 200])
def test_nms_op_passes_opcheck(k):
    boxes, scores = _planted_scene(k, 0.5, pairs=k // 2, extra=k - 2 * (k // 2))
    valid = torch.from_numpy(scores.max(-1) > 0.3)
    torch.library.opcheck(torch.ops.dyd.nms_suppress.default,
                          (torch.from_numpy(boxes), valid, torch.tensor(0.5)))


OPS_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[2])
from deal_yolo_daya_tpu_torch.ops.kernels import register_ops
register_ops()
ep = torch.export.load(sys.argv[1])
qkv = torch.linspace(-1, 1, 2 * 10 * 128).reshape(2, 10, 128)
boxes = torch.tensor([[[0., 0., 10., 10.], [1., 1., 10., 10.], [20., 20., 30., 30.]]])
keep, out = ep.module()(qkv, boxes, torch.tensor(0.5))
print(keep.tolist(), float(out.abs().sum()))
print(sorted(m for m in sys.modules if m.startswith("deal_yolo_daya_tpu_torch.models")))
"""


def test_a_program_holding_the_ops_loads_after_register_ops(tmp_path):
    """The custom ops survive torch.export and its save: a fresh process that
    registers them (and imports no model class) runs the program."""

    class Ops(torch.nn.Module):
        def forward(self, qkv, boxes, iou):
            out, _ = torch.ops.dyd.area_attention_fwd(qkv, 2, 32, 16)
            keep = torch.ops.dyd.nms_suppress(boxes, torch.ones_like(boxes[..., 0], dtype=bool),
                                              iou)
            return keep, out

    qkv = torch.linspace(-1, 1, 2 * 10 * 128).reshape(2, 10, 128)
    boxes = torch.tensor([[[0., 0., 10., 10.], [1., 1., 10., 10.], [20., 20., 30., 30.]]])
    exported = torch.export.export(Ops(), (qkv, boxes, torch.tensor(0.5)))
    assert {"dyd.area_attention_fwd.default", "dyd.nms_suppress.default"} <= \
        {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    torch.export.save(exported, str(tmp_path / "ops.pt2"))
    out = subprocess.run([sys.executable, "-c", OPS_CHILD, str(tmp_path / "ops.pt2"), str(REPO)],
                         cwd=tmp_path, check=True, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    keep_line, models_line = out.stdout.strip().splitlines()[-2:]
    keep, out_sum = Ops()(qkv, boxes, torch.tensor(0.5))
    assert keep_line == f"{keep.tolist()} {float(out_sum.abs().sum())}"
    assert keep.tolist() == [[True, False, True]]
    assert models_line == "[]"

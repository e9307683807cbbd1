"""The port's YOLOv10 on the CPU against the plain reference
``benchmark/reference/yolov10.py`` (torch alone), both on the same seeded random
weights: both heads' train-mode outputs, the dual loss, every leaf's
gradient, the detach of the one-to-one head, the eval forward and the
NMS-free selection; the deployed parameter counts of the six scales; the
registry, ``infer_arch`` and the ultralytics key map; a two-step Trainer
run; the paths that refuse a yolov10.

Tolerances (f32, 2-image batches, train-mode BatchNorm):
- head outputs: max |port - reference| <= 1e-3 x max |reference| per level:
  the two compute BatchNorm and attention in other orders, and ~100
  batch-statistics BatchNorms of 2 images amplify f32 rounding (measured
  9.1e-5 at yolov10m 128 px, 2.0e-5 at yolov10n);
- the loss: relative 1e-5 (measured 4e-7 and 7e-7);
- gradients: ||port - reference|| <= 5e-3 x max(||reference||, 1% of the
  median leaf's norm) for every leaf (measured worst 6.3e-4): a BatchNorm
  bias in front of another batch-statistics BatchNorm has a gradient of
  rounding noise alone (~1e-7), hence the floor;
- eval outputs (running statistics at identity): 1e-4 relative; the
  selection on the same decoded inputs: equal.
The port's assigner ranks anchors by a bf16 metric (``train/loss.py``); the
reference's is f32, as ultralytics'. The comparison of losses and gradients
runs the port's in f32 (``_MetricInF32``, as ``benchmark/tests/
test_bench_reference.py`` does), so that both assign the same anchors; the
bf16 ranking itself is the port's convention, held elsewhere
(``tests/test_torch_port_train.py`` against the JAX package).
"""

import statistics
import sys
from pathlib import Path

import pytest
import torch

from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models.registry import (FAMILIES, end_to_end, infer_arch,
                                                      make_detector, parse_model_spec)
from deal_yolo_daya_tpu_torch.models.torch_import import import_state_dict, v10_keys
from deal_yolo_daya_tpu_torch.models.yolo11 import fuse_conv_bn, init_weights
from deal_yolo_daya_tpu_torch.models.yolov10 import (YOLOV10_SCALES, DualOutputs, YOLOv10,
                                                     deployed_param_count)
from deal_yolo_daya_tpu_torch.ops.decode import decode_predictions
from deal_yolo_daya_tpu_torch.ops.nms import v10_select
from deal_yolo_daya_tpu_torch.train import loss as port_loss
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, TrainState
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from benchmark.reference import yolov10 as R  # noqa: E402

# the deployed model (one-to-one head only, BatchNorm folded, nc 80) by scale
DEPLOYED = {"n": 2_299_248, "s": 7_248_944, "m": 15_359_472, "b": 19_065_776,
            "l": 24_370_992, "x": 29_473_552}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


class _MetricInF32:
    """``torch`` as the port's loss module sees it, with bfloat16 taken as
    float32: its assigner's align metric then runs in f32."""

    bfloat16 = torch.float32

    def __getattr__(self, name):
        return getattr(torch, name)


def _cfg(scale):
    d, w, mc = YOLOV10_SCALES[scale]
    return dict(scale=scale, depth_multiple=d, width_multiple=w, max_channels=mc, nc=80)


def _pair(scale, seed=7):
    """The reference and the port on the reference's weights from ``seed``."""
    sd = R.make_weights(_cfg(scale), seed, "cpu")
    ref = R.Detector(_cfg(scale))
    ref.load_state_dict(sd)
    port = make_detector("yolov10", scale)
    port.load_state_dict(v10_keys(sd))
    return ref, port


def _batch(s):
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 3, s, s, generator=g)
    boxes = torch.tensor([[[2., 3., s * 0.7, s * 0.8], [s * 0.3, s * 0.2, s * 0.9, s * 0.6],
                           [0, 0, 0, 0]],
                          [[s * 0.1, s * 0.1, s * 0.5, s * 0.95], [0, 0, 0, 0], [0, 0, 0, 0]]])
    cls = torch.tensor([[1, 5, 0], [7, 0, 0]])
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]]).bool()
    return x, boxes, cls, mask


@pytest.mark.parametrize("scale", ["m", "n"])
def test_train_outputs_loss_and_gradients_equal_the_reference(scale, monkeypatch):
    monkeypatch.setattr(port_loss, "torch", _MetricInF32())
    s = 128
    ref, port = _pair(scale)
    ref.train()
    port.train()
    x, boxes, cls, mask = _batch(s)
    ro, po = ref(x), port(x)
    assert isinstance(po, DualOutputs)
    for head in ("one2many", "one2one"):
        for want, got in zip(ro[head][0] + ro[head][1], getattr(po, head)[0] + getattr(po, head)[1]):
            assert got.shape == want.shape
            assert (got - want).abs().max() <= 1e-3 * want.abs().max(), head
    rl, (fg1, fg2) = R.dual_loss(ro, cls, boxes, mask, s, 80)
    pl, parts = port_loss.dual_detection_loss(po, cls, boxes, mask, (s, s))
    assert abs(pl.item() - rl.item()) <= 1e-5 * abs(rl.item())
    assert (parts["num_fg"].item(), parts["num_fg_o2o"].item()) == (fg1.item(), fg2.item())
    assert fg2.item() <= int(mask.sum())     # top-k 1: at most one anchor a GT
    rl.backward()
    pl.backward()
    ref_params = v10_keys(dict(ref.named_parameters()))
    rows = []
    for name, p in port.named_parameters():
        q = ref_params[name]
        gp = torch.zeros_like(p) if p.grad is None else p.grad
        gq = torch.zeros_like(q) if q.grad is None else q.grad
        rows.append((name, (gp - gq).norm().item(), gq.norm().item()))
    floor = 1e-2 * statistics.median(n for _, _, n in rows)
    bad = [(name, d, n) for name, d, n in rows if d > 5e-3 * max(n, floor)]
    assert not bad, bad[:5]


def test_one_to_one_head_sends_no_gradient_into_the_backbone():
    port = init_weights(make_detector("yolov10", "n"), 0).train()
    x, boxes, cls, mask = _batch(64)
    out = port(x)
    loss, parts = port_loss.detection_loss(*out.one2one, cls, boxes, mask, (64, 64),
                                           port_loss.LossConfig(tal_topk=1))
    loss.backward()
    moved = {n for n, p in port.named_parameters() if p.grad is not None and p.grad.any()}
    assert moved and all(n.startswith(("23.one2one_cv2.", "23.one2one_cv3.")) for n in moved)
    assert parts["num_fg"].item() <= int(mask.sum())


@pytest.mark.parametrize("scale", ["m", "n"])
def test_eval_forward_and_selection_equal_the_reference(scale):
    ref, port = _pair(scale, seed=11)
    ref.eval()
    port.eval()
    x = _batch(128)[0]
    with torch.no_grad():
        rbox, rcls = ref(x)
        pbox, pcls = port(x)
        fbox, fcls = fuse_conv_bn(port)(x)
    for want, got, fused in zip(rbox + rcls, pbox + pcls, fbox + fcls):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        assert (fused - want).abs().max() <= 1e-4 * want.abs().max()
    boxes, scores = R.decode(rbox, rcls, 128)
    pb, ps = decode_predictions(pbox, pcls, (128, 128))
    assert (pb - boxes).abs().max() <= 1e-3 and (ps - scores).abs().max() <= 1e-5
    for max_det, conf in ((300, 0.0), (50, 0.0), (300, float(scores.amax(-1).median()))):
        ob, osc, ocl, nd = v10_select(boxes, scores, max_det, conf)
        want = R.postprocess(boxes, scores, max_det, conf)
        for i, (wb, ws, wc) in enumerate(want):
            n = int(nd[i])
            assert n == len(ws)
            assert torch.equal(ob[i, :n], wb) and torch.equal(osc[i, :n], ws)
            assert torch.equal(ocl[i, :n].long(), wc)
            assert (ocl[i, n:] == -1).all() and (osc[i, n:] == 0).all()


def test_selection_pads_fewer_anchors_than_max_det():
    g = torch.Generator().manual_seed(0)
    boxes, scores = torch.rand(2, 21, 4, generator=g), torch.rand(2, 21, 3, generator=g)
    ob, osc, ocl, nd = v10_select(boxes, scores, 300, 0.5)
    assert ob.shape == (2, 300, 4) and osc.shape == (2, 300) and ocl.dtype == torch.int32
    for i, (wb, ws, wc) in enumerate(R.postprocess(boxes, scores, 300, 0.5)):
        assert int(nd[i]) == len(ws) and torch.equal(osc[i, :len(ws)], ws)


@pytest.mark.parametrize("scale", sorted(DEPLOYED))
def test_deployed_parameter_count(scale):
    with torch.device("meta"):
        model = make_detector("yolov10", scale)
    assert deployed_param_count(model) == DEPLOYED[scale]


@pytest.mark.parametrize("spec,want", [
    ("yolov10m", ("yolov10", "m")), ("yolo10n.yaml", ("yolov10", "n")),
    ("runs/x/yolov10b.yaml", ("yolov10", "b")), ("yolov10x.pt", ("yolov10", "x")),
    ("yolo11m", ("yolo11", "m")), ("yolo11b", ("yolo11", "n")), ("m", ("yolo11", "m")),
])
def test_parse_model_spec_knows_yolov10(spec, want):
    assert parse_model_spec(spec) == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_end_to_end_decision_is_the_models(family):
    """api, serve and the trainer ask the model (``END2END``), not its name:
    yolov10 alone is end to end, and a BN-folded copy says so too."""
    with torch.device("meta"):
        model = make_detector(family, "n")
    assert end_to_end(family) == model.END2END == (family == "yolov10")
    assert fuse_conv_bn(init_weights(make_detector(family, "n"), 0).eval()).END2END \
        == model.END2END

def test_yolo_and_train_config_build_yolov10m():
    assert isinstance(YOLO("yolov10m", device="cpu")._ensure_built(), YOLOv10)
    state = TrainState(TrainConfig(model="yolov10m", amp=False), 80, 10, device="cpu")
    assert (state.family, state.scale, state.dual) == ("yolov10", "m", True)


@pytest.mark.parametrize("scale", sorted(DEPLOYED))
def test_infer_arch_tells_yolov10_from_yolo11(scale):
    with torch.device("meta"):
        sd = make_detector("yolov10", scale).state_dict()
        y11 = make_detector("yolo11", "m").state_dict()
    assert infer_arch(sd) == ("yolov10", scale)
    assert infer_arch({f"model.{k}": v for k, v in sd.items()}) == ("yolov10", scale)
    assert infer_arch(y11) == ("yolo11", "m")


def _ultralytics_keys(sd):
    """A port yolov10 state dict under ultralytics' keys: the PSA's
    ``10.attn.*``/``10.ffn.*``, the ``model.`` prefix, BN bookkeeping."""
    out = {}
    for k, v in sd.items():
        k = k.replace("10.m.0.attn.", "10.attn.").replace("10.m.0.ffn.", "10.ffn.")
        out[f"model.{k}"] = v
        if k.endswith("running_var"):
            out[f"model.{k[:-len('running_var')]}num_batches_tracked"] = torch.tensor(3)
    out["model.23.dfl.conv.weight"] = torch.arange(16.0).view(1, 16, 1, 1)
    return out


def test_import_maps_ultralytics_yolov10_keys():
    src = init_weights(make_detector("yolov10", "s"), 5).state_dict()
    ul = _ultralytics_keys(src)
    assert "model.10.attn.qkv.conv.weight" in ul and "model.10.ffn.1.bn.bias" in ul
    assert infer_arch(ul) == ("yolov10", "s")
    target = make_detector("yolov10", "s")
    new, report = import_state_dict(ul, target, strict=True)
    assert not report["missing"] and not report["unused"]
    for k, v in src.items():
        assert torch.equal(new[k], v), k


def test_import_completes_a_fused_repvggdw():
    """A fused ultralytics yolov10n (BN folded, RepVGGDW's 3x3 merged into
    its 7x7) imports strictly and computes what the fused port computes."""
    model = init_weights(make_detector("yolov10", "n"), 2).eval()
    with torch.no_grad():  # BN statistics away from identity
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
            elif name.endswith("running_mean"):
                buf.uniform_(-0.2, 0.2)
    fused = fuse_conv_bn(model)
    sd = {k: v for k, v in fused.state_dict().items() if ".bn." not in k}
    assert not any(".conv1." in k for k in sd)
    new, report = import_state_dict(_ultralytics_keys(sd), make_detector("yolov10", "n"))
    assert any("RepVGGDW" in f for f in report["fused"])
    back = make_detector("yolov10", "n").eval()
    back.load_state_dict(new)
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        want, got = model(x), back(x)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_two_step_trainer_run_of_yolov10n(tmp_path):
    from deal_yolo_daya_tpu_torch import tracing
    from tests.test_data import make_dataset

    data = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    yolo = YOLO("yolov10n.yaml", device="cpu")
    yolo.train(str(data), epochs=1, imgsz=64, batch=4, amp=False, close_mosaic=0, max_boxes=16,
               workers=1, project=str(tmp_path / "runs"), name="v10", warmup_epochs=0.5)
    state = yolo.trainer.state
    assert (yolo.family, yolo.scale, state.updates) == ("yolov10", "n", 2)
    acc = {k: float(v) for k, v in state.loss_acc.items()}
    # the one-to-one head's parts beside the sums (64 px toy objects are too
    # small for either head to find a foreground anchor at random weights)
    assert set(port_loss.O2O_PARTS) <= set(acc) and acc["cls_loss_o2o"] > 0
    assert (Path(yolo.save_dir) / "weights" / "best.pt").exists()
    before = tracing.totals().get("predict.select")
    dets = yolo.predict(str(Path(data).parent / "images" / "val"), conf=0.0, max_det=20)
    after = tracing.totals()["predict.select"]
    assert len(dets) == 4 and all(len(d) == 20 for d in dets)
    assert after.count - (before.count if before else 0) == 1
    again = YOLO(str(Path(yolo.save_dir) / "weights" / "best.pt"), device="cpu")
    assert (again.family, again.scale) == ("yolov10", "n")


@pytest.mark.parametrize("what", ["engine", "export", "export_stablehlo", "quantize_int8",
                                  "train_state_attach", "trainer_mesh"])
def test_paths_without_a_yolov10_route_refuse_it(what, tmp_path, monkeypatch):
    from deal_yolo_daya_tpu_torch import serve
    from deal_yolo_daya_tpu_torch.train.trainer import Trainer

    yolo = YOLO("yolov10n", device="cpu")
    calls = {
        "engine": lambda: serve.Engine(yolo),
        "export": lambda: yolo.export(tmp_path / "bundle"),
        "export_stablehlo": lambda: yolo.export_stablehlo(tmp_path / "prog"),
        "quantize_int8": lambda: yolo.quantize_int8([torch.zeros(8, 8, 3).numpy()]),
        "train_state_attach": lambda: TrainState(TrainConfig(model="yolov10n", amp=False), 80,
                                                 10, device="cpu").attach(object()),
        "trainer_mesh": lambda: Trainer(TrainConfig(model="yolov10n", device="2x2")),
    }
    monkeypatch.setenv("DYD_CPU_DEVICES", "4")  # a 2 x 2 mesh of CPU devices
    with pytest.raises(NotImplementedError, match="yolov10"):
        calls[what]()

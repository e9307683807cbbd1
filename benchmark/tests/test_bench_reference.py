"""The frozen reference agrees with the program on the CPU at a tiny size,
so that a drift of either shows: the detectors' forwards, the draws and the
augmentation, the loss, the optimizer and EMA, the letterbox and NMS."""

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.lib import traffic
from benchmark.reference import detect, model as ref, train as rt

S = 64


def cfg(name):
    return R.load_json(R.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["yolo11n", "yolo12n"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_agrees(name, mode, cpu_threads):
    from deal_yolo_daya_tpu_torch.models.registry import make_detector

    c = cfg(name)
    sd = ref.make_weights(c, 3, "cpu", S, {"gain": 2.0, "class_bias": "zero",
                                           "head_std": [1.0, 1.0]})
    m = ref.Detector(c)
    m.load_state_dict(sd)
    p = make_detector(c["family"], c["scale"], c["nc"])
    p.load_state_dict(sd, strict=True)
    getattr(m, mode)()
    getattr(p, mode)()
    x = torch.rand((2, 3, S, S), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = m(x), p(x)
    for la, lb in zip(a[0] + a[1], b[0] + b[1]):
        assert (la - lb).abs().max() <= 1e-3 * la.abs().max() + 1e-5


def _batch(b=4):
    p = {"images": 8, "aspect": [0.5, 2.0], "boxes": [1, 8], "boxes_mean": 3.0,
         "box_side": [0.1, 0.8], "classes": 80}
    cache = traffic.device_cache(5, p, S, 16, "cpu")
    return tuple(t[:b] for t in cache)


def test_draws_and_augmentation_agree():
    from deal_yolo_daya_tpu_torch.train import device_augment as da

    raw = _batch()
    d = rt.draws(4, 77, rt.AugParams(), "cpu")
    dr = da.draw(4, torch.Generator().manual_seed(77), da.DeviceAugConfig(), "cpu")
    assert torch.equal(d["u"], dr.uniforms) and torch.equal(d["partners"], dr.partners)
    assert torch.equal(d["gains"], dr.gains) and torch.equal(d["flips"], dr.flips)
    pi, pb, pc, pm = da.apply(*raw, dr, S, da.DeviceAugConfig(), 16)
    ri, rb, rc, rm = rt.augment(*raw, d, S, rt.AugParams(), 16)
    diff = (pi.int() - ri.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
    assert torch.equal(pm, rm) and torch.equal(pc, rc)
    assert (pb - rb).abs().max() < 1e-3


class _MetricInF32:
    """``torch`` as the program's loss module sees it, with bfloat16 taken
    as float32: its assigner's align metric then runs in f32, as the
    reference's does."""

    bfloat16 = torch.float32

    def __getattr__(self, name):
        return getattr(torch, name)


def test_loss_agrees(cpu_threads, monkeypatch):
    from deal_yolo_daya_tpu_torch.train import loss as program_loss
    from deal_yolo_daya_tpu_torch.train.loss import LossConfig, detection_loss

    c = cfg("yolo11n")
    m = ref.Detector(c)
    m.load_state_dict(ref.make_weights(c, 3, "cpu", S, {"gain": 1.0, "class_bias": "prior"}))
    d = rt.draws(4, 5, rt.AugParams(), "cpu")
    imgs, bx, cl, mk = rt.augment(*_batch(), d, S, rt.AugParams(), 16)
    box, cls = m.train()(imgs.permute(0, 3, 1, 2).float() / 255)
    a, _ = rt.detection_loss(box, cls, cl, bx, mk, S, 80)
    monkeypatch.setattr(program_loss, "torch", _MetricInF32())
    b, _ = detection_loss(box, cls, cl, bx, mk, (S, S), LossConfig(nc=80))
    ga = torch.autograd.grad(a, box + cls, retain_graph=True)
    gb = torch.autograd.grad(b, box + cls)
    assert float(a) == pytest.approx(float(b), rel=1e-5)
    for x, y in zip(ga, gb):
        assert (x - y).abs().max() <= 1e-4 * y.abs().max() + 1e-9


def test_sgd_and_ema_agree():
    from deal_yolo_daya_tpu_torch.train.optimizer import (N_HYPER, Optimizer, OptimizerConfig,
                                                          ema_decay, ema_update)
    from deal_yolo_daya_tpu_torch.models.registry import make_detector

    hp = R.load_json(R.HERE / "workloads" / "yolo11n.train.b32.json")["optimizer"]
    prog = make_detector("yolo11", "n", 80)
    mine = ref.Detector(cfg("yolo11n"))
    mine.load_state_dict(prog.state_dict())
    opt = Optimizer(OptimizerConfig(name=hp["name"], lr0=hp["lr0"], lrf=hp["lrf"],
                                    momentum=hp["momentum"], weight_decay=hp["weight_decay"],
                                    warmup_epochs=hp["warmup_epochs"], epochs=hp["epochs"],
                                    steps_per_epoch=32), prog)
    params = [p.detach() for p in prog.parameters()]
    ema = [p.clone() for p in params]
    named = list(mine.named_parameters())
    sgd = rt.SGD(named, hp, 32)
    gen = torch.Generator().manual_seed(1)
    for step in range(3):
        grads = {k: torch.randn(p.shape, generator=gen) for k, p in named}
        for k, p in prog.named_parameters():
            p.grad.copy_(grads[k])
        for k, p in named:
            p.grad = grads[k].clone()
        hyper = torch.zeros(N_HYPER)
        for col, v in opt.hyper_row(step).items():
            hyper[col] = v
        opt.step(hyper)
        ema_update(ema, params, torch.tensor(ema_decay(step + 1)))
        sgd.step()
    for (k, p), (_, q), e in zip(prog.named_parameters(), named, ema):
        assert torch.allclose(p, q, rtol=1e-5, atol=1e-7), k
        assert torch.allclose(e, sgd.ema[k], rtol=1e-5, atol=1e-7), k


def test_letterbox_and_nms_agree(cpu_threads):
    from deal_yolo_daya_tpu_torch.ops.letterbox import letterbox_numpy
    from deal_yolo_daya_tpu_torch.ops.nms import batched_nms

    pool = traffic.image_pool(4, {"images": 4, "long_side": [40, 120], "aspect": [0.5, 2.0]},
                              "cpu")
    for img in pool:
        canvas, r, pad = letterbox_numpy(img, S)
        mine, r2, px, py = detect.letterbox(img, S, "cpu")
        assert (r, pad) == (r2, (px, py))
        assert np.abs(canvas.astype(int) - mine.numpy().astype(int)).max() <= 1
    gen = torch.Generator().manual_seed(2)
    xy = torch.rand((2, 400, 2), generator=gen) * 60
    wh = torch.rand((2, 400, 2), generator=gen) * 30 + 2
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand((2, 400, 5), generator=gen)
    _, _, _, n_det = batched_nms(boxes, scores, 0.25, 0.5, pre_topk=300, max_det=100)
    for i in range(2):
        keep = detect.nms_keep(boxes[i], scores[i], 0.25, 0.5, pre_topk=300, max_det=100)
        assert len(keep) == int(n_det[i])

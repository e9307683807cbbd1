"""The port's YOLOv8 and YOLOv12 families, yolo11 m/l/x and the registry
against the JAX package on the CPU: parameter counts, spec parsing and
architecture inference, the weight carry-over, raw head outputs, AAttn with
the Pallas kernel (interpret mode) and the einsum path, one yolo12n train
step, the family in checkpoints, and gamma's optimizer group. Inputs and
weights are numpy-made from seeds; f32."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deal_yolo_daya_tpu.models import blocks as jax_blocks
from deal_yolo_daya_tpu.models.registry import make_detector as jax_make_detector
from deal_yolo_daya_tpu.models.registry import parse_model_spec as jax_parse_model_spec
from deal_yolo_daya_tpu.models.torch_import import export_state_dict
from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import blocks, registry
from deal_yolo_daya_tpu_torch.models import (YOLOv8, YOLOv12, build_detector, infer_arch,
                                             make_detector, param_count, parse_model_spec,
                                             state_dict_from_jax)
from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa_mod
from deal_yolo_daya_tpu_torch.train import optimizer as port_opt
from deal_yolo_daya_tpu_torch.train.trainer import (CHECKPOINT_FORMAT, TrainConfig, TrainState,
                                                    Trainer, load_checkpoint)

IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's CPU ops here run on two threads, restored afterwards: the
    test workers share the machine's cores, and PyTorch's default of one
    thread a core oversubscribes them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)

# ultralytics' detect-model counts at nc 80 (the JAX package's pinned values:
# tests/test_yolov12.py, tests/test_yolov8.py, tests/test_model.py), which
# include the 16 fixed DFL weights that both packages compute arithmetically
COUNTS = {
    ("yolo12", "n"): 2_602_288, ("yolo12", "s"): 9_284_096, ("yolo12", "m"): 20_199_168,
    ("yolo12", "l"): 26_450_784, ("yolo12", "x"): 59_210_784,
    ("yolov8", "n"): 3_157_200, ("yolov8", "s"): 11_166_560, ("yolov8", "m"): 25_902_640,
    ("yolov8", "l"): 43_691_520, ("yolov8", "x"): 68_229_648,
    ("yolo11", "n"): 2_624_080, ("yolo11", "s"): 9_458_752, ("yolo11", "m"): 20_114_688,
    ("yolo11", "l"): 25_372_160, ("yolo11", "x"): 56_966_176,
}


@pytest.mark.parametrize("family,scale", sorted(COUNTS))
def test_param_counts_equal_jax(family, scale):
    with torch.device("meta"):  # shapes only: no memory, no init
        model = make_detector(family, scale, 80)
    assert param_count(model) + 16 == COUNTS[(family, scale)]


SPECS = ["yolo12n", "yolov12s", "yolo12x.yaml", "/cfg/models/12/yolo12m.yaml", "yolo11l",
         "yolov8l", "yolov8s", "yolov8x.yaml", "/cfg/models/v8/yolov8m.yaml", "s",
         "unknown_model", "yolo11n", "runs/train/yolo12l.pt"]


def test_parse_model_spec_gives_the_jax_answers():
    for spec in SPECS:
        assert parse_model_spec(spec) == jax_parse_model_spec(spec), spec
    assert parse_model_spec("unknown_model") == ("yolo11", "n")


@functools.lru_cache(maxsize=None)
def _shapes(family, scale, nc):
    """The JAX detector and the shapes of its variables, traced once
    (``jax.eval_shape``: nothing is compiled)."""
    model = jax_make_detector(family, scale, nc)
    return model, jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False),
        jax.random.PRNGKey(0))


def _random_tree(family, scale, seed=0, nc=80):
    """A JAX variables tree of the family with numpy-made values (BN
    variances positive), built without compiling."""
    model, shapes = _shapes(family, scale, nc)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.6, s.shape).astype(np.float32)
        if name == "gamma":
            return rng.uniform(0.5, 1.0, s.shape).astype(np.float32)
        return rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, {c: jax.tree_util.tree_map(lambda a: a, tree[c])
                   for c in ("params", "batch_stats")}


@pytest.mark.parametrize("family,scale", [("yolov8", "n"), ("yolo12", "n"), ("yolo12", "l")])
def test_carry_over_equals_jax_export_and_loads_strict(family, scale):
    _, variables = _random_tree(family, scale)
    want = export_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    with torch.device("meta"):  # keys and shapes: strict loading checks both
        model = make_detector(family, scale, 80)
    result = model.load_state_dict(got, strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert ("8.gamma" in got) == (scale == "l")  # gamma only with the l/x residual
    assert infer_arch(want) == (family, scale)
    assert infer_arch({f"model.{k}": v for k, v in want.items()}) == (family, scale)


@pytest.mark.parametrize("family,scale", [("yolo11", "m"), ("yolo11", "l"), ("yolo12", "m"),
                                          ("yolov8", "x"), ("yolo11", "n")])
def test_infer_arch_recovers_family_and_scale(family, scale):
    with torch.device("meta"):
        sd = make_detector(family, scale, 5).state_dict()
    assert infer_arch(sd) == (family, scale)


def test_infer_arch_refuses_other_state_dicts():
    with pytest.raises(ValueError, match="not a YOLO11/YOLOv8/YOLOv12"):
        infer_arch({"0.conv.weight": torch.zeros(16, 3, 3, 3)})


@pytest.fixture(scope="module", params=[("yolov8", "n"), ("yolo12", "n")])
def both_models(request):
    family, scale = request.param
    model, variables = _random_tree(family, scale, seed=3)
    port = make_detector(family, scale, 80)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


def test_raw_head_outputs_match_jax(both_models):
    model, variables, port = both_models
    x = np.random.default_rng(2).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jbox, jcls = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tbox, tcls = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(t.shape) for t in tbox] == [(2, 64, 8, 8), (2, 64, 4, 4), (2, 64, 2, 2)]
    assert [tuple(t.shape) for t in tcls] == [(2, 80, 8, 8), (2, 80, 4, 4), (2, 80, 2, 2)]
    for j, t in zip(jbox + jcls, tbox + tcls):
        j = np.asarray(j)
        assert j.std() > 0.05  # not degenerate
        # f32, different conv summation order: 1e-4 of the output scale, as
        # tests/test_torch_port_model.py holds yolo11n
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), j,
                                   rtol=1e-4, atol=1e-4 * np.abs(j).max())


def _aattn_state_dict(variables):
    """The JAX AAttn tree -> the port module's state dict (qkv, proj, pe)."""
    sd = {}
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    for coll in ("params", "batch_stats"):
        for mod, parts in variables[coll].items():
            for part, leaves in parts.items():
                for name, arr in leaves.items():
                    a = np.array(arr, np.float32)
                    if name == "kernel":
                        a = a.transpose(3, 2, 0, 1)
                    sd[f"{mod}.{part}.{leaf[name]}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


@pytest.mark.parametrize("pallas", [True, False])
def test_aattn_area4_matches_jax(pallas):
    """(2, 4, 8, 64): 32 tokens in 4 stripes of 8, 2 heads of 32 (key_dim =
    head_dim = 32); the JAX side through the Pallas kernel in interpret mode
    or through its einsum path."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 4, 8, 64)).astype(np.float32)
    mod = jax_blocks.AAttn(64, 2, area=4)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if a.ndim == 1 else a, variables)  # non-trivial BN
    saved = jax_blocks.AATTN_PALLAS
    jax_blocks.AATTN_PALLAS = pallas
    try:
        want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    finally:
        jax_blocks.AATTN_PALLAS = saved
    port = blocks.AAttn(64, 2, area=4)
    port.load_state_dict(_aattn_state_dict(variables), strict=True)
    before = aa_mod.launches
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert aa_mod.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4)


def test_aattn_and_a2c2f_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="not divisible by area=4"):
        blocks.AAttn(64, 2, area=4)(torch.zeros((1, 64, 3, 3)))
    with pytest.raises(ValueError, match="not a multiple of 32"):
        blocks.A2C2f(48, 48, a2=True)  # hidden 24
    blocks.A2C2f(48, 48, a2=False)    # C3k inners take any width
    assert blocks.A2C2f(64, 64, residual=True).gamma is not None
    assert blocks.A2C2f(64, 64, a2=False, residual=True).gamma is None
    assert torch.equal(blocks.A2C2f(64, 64, residual=True).gamma, torch.full((64,), 0.01))


def test_yolo12_attention_runs_at_32_32():
    """Every attention call of yolo12n asks for (key_dim, head_dim) = (32, 32),
    a pair the kernels are built for; 8 calls a forward."""
    calls = []

    def spy(qkv, heads, hd, kd=None):
        calls.append((tuple(qkv.shape), heads, kd or hd, hd))
        return aa_mod.area_attention_plain(qkv, heads, hd, kd)

    model = build_detector("yolo12n", nc=3, device="cpu")
    orig = blocks.area_attention
    blocks.area_attention = spy
    try:
        with torch.no_grad():
            model(torch.zeros((2, 3, IMGSZ, IMGSZ)))
    finally:
        blocks.area_attention = orig
    assert len(calls) == 8
    assert {c[2:] for c in calls} == {(32, 32)} and (32, 32) in aa_mod.SUPPORTED
    assert {c[0] for c in calls} == {(8, 4, 192), (2, 4, 384)}  # b6 area 4, b8 area 1


def test_param_groups_put_gamma_in_no_decay():
    with torch.device("meta"):
        model = make_detector("yolo12", "l", 3)
    groups = port_opt.param_groups(model)
    gammas = [m.gamma for m in model.modules() if isinstance(m, blocks.A2C2f)
              and m.gamma is not None]
    assert len(gammas) == 2  # b6 and b8
    for g in gammas:
        assert any(p is g for p in groups["no_decay"])
        assert not any(p is g for p in groups["decay"] + groups["bias"])


def test_registry_builds_every_family():
    assert set(registry.FAMILIES) == {"yolo11", "yolov8", "yolo12"}
    assert isinstance(build_detector("yolov8n", nc=3, device="cpu"), YOLOv8)
    model = build_detector("yolo12n", nc=3, device="cpu")
    assert isinstance(model, YOLOv12) and not model.training
    assert model.head() is model.layer(21) and model.head().nc == 3
    with pytest.raises(ValueError, match="unknown model family"):
        make_detector("yolo9", "n")
    with pytest.raises(ValueError, match="scale 'q'"):
        make_detector("yolo12", "q")


# ---------------------------------------------------------------- one train step
# The harness of tests/test_torch_port_train.py (the JAX Trainer at 128 px,
# batch 4, f32, nesterov SGD, no warmup, on the fixed batch, with flax's
# two-pass batch variance while it traces) for yolo12n, one step: its
# parameter deltas carry the gradients.

from tests.test_torch_port_train import (DELTA_RTOL, GRAD_ATOL, STATS_RTOL,  # noqa: E402
                                          STEP_BATCH, STEP_IMGSZ, STEP_LR0, STEP_NC, ULPS,
                                          _close, _fixed_batch, _np_tree, _small_box_head)


@pytest.fixture(scope="module")
def yolo12_step(tmp_path_factory):
    from flax.linen import normalization

    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer
    from tests.test_data import make_dataset

    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    tmp = tmp_path_factory.mktemp("port_v12_step")
    data_yaml = make_dataset(tmp, n_train=8, n_val=4, imgsz=STEP_IMGSZ, nc=STEP_NC)
    trainer = JaxTrainer(JaxTrainConfig(
        model="yolo12n", data=str(data_yaml), epochs=3, imgsz=STEP_IMGSZ, batch=STEP_BATCH,
        amp=False, close_mosaic=0, project=str(tmp / "runs"), name="t", seed=0, device="1",
        max_boxes=16, lr0=STEP_LR0, warmup_epochs=0, workers=1, device_augment=False))
    images, boxes, classes, mask = _fixed_batch()
    params = _small_box_head(trainer.state.params)
    state = trainer.state._replace(params=params,
                                   ema_params=jax.tree_util.tree_map(jnp.copy, params))
    initial = {"params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats)}
    normalization._compute_stats = two_pass_stats  # while the step is traced
    try:
        state, _, acc = trainer.train_step(state, trainer.zero_loss_acc(), images, boxes,
                                           classes, mask)
        after = {"params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats),
                 "ema": _np_tree(state.ema_params), "acc": {k: float(v) for k, v in acc.items()}}
    finally:
        normalization._compute_stats = compute_stats

    cfg = TrainConfig(model="yolo12n", epochs=3, imgsz=STEP_IMGSZ, amp=False, seed=0,
                      max_boxes=16, lr0=STEP_LR0, warmup_epochs=0)
    port = TrainState(cfg, nc=STEP_NC, steps_per_epoch=len(trainer.train_loader), device="cpu",
                      state_dict=state_dict_from_jax(initial))
    assert port.family == "yolo12" and isinstance(port.model, YOLOv12)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    port.step(*(torch.from_numpy(np.array(a)) for a in (images, boxes, classes, mask)))
    return {"jax_initial": initial, "jax_after": after, "port_before": before,
            "port_after": port.model.state_dict(), "port_ema": port.ema_state_dict(),
            "port_acc": {k: float(v) for k, v in port.loss_acc.items()}}


def test_yolo12n_train_step_matches_jax(yolo12_step):
    """Loss parts to 1e-4 (the foreground count exactly), each parameter's
    delta and EMA move within DELTA_RTOL of its largest entry, BN running
    statistics to STATS_RTOL, as tests/test_torch_port_train.py holds the
    yolo11n step."""
    r = yolo12_step
    want, got = r["jax_after"]["acc"], r["port_acc"]
    assert got["num_fg"] == want["num_fg"] > 0
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    old = state_dict_from_jax({"params": r["jax_initial"]["params"]})
    new = state_dict_from_jax({"params": r["jax_after"]["params"]})
    ema = state_dict_from_jax({"params": r["jax_after"]["ema"]})
    moved = 0
    for name in new:
        want_d = (new[name] - old[name]).numpy()
        moved += bool(np.abs(want_d).max() > 0)
        floor = ULPS * float(np.abs(old[name].numpy()).max()) + 2 * STEP_LR0 * GRAD_ATOL
        got_d = (r["port_after"][name] - r["port_before"][name]).numpy()
        _close(got_d, want_d, DELTA_RTOL, f"delta {name}", atol=floor)
        got_e = (r["port_ema"][name] - r["port_before"][name]).numpy()
        _close(got_e, (ema[name] - old[name]).numpy(), DELTA_RTOL, f"ema {name}", atol=floor)
    assert moved > len(new) // 2
    assert any(".m.0.0.attn.qkv." in n for n in new)  # the attention stages took part
    stats = state_dict_from_jax({"batch_stats": r["jax_after"]["batch_stats"]})
    for name, want_s in stats.items():
        np.testing.assert_allclose(r["port_after"][name].numpy(), want_s.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=name)


# ---------------------------------------------------------------- checkpoints


def _tiny_dataset(root):
    from tests.test_data import make_dataset

    return make_dataset(root, n_train=4, n_val=2, imgsz=64, nc=2)  # under root / "ds"


def test_trainer_checkpoint_records_the_family_and_reloads(tmp_path):
    data_yaml = _tiny_dataset(tmp_path)
    trainer = Trainer(TrainConfig(model="yolo12n", data=str(data_yaml), epochs=1, imgsz=64,
                                  batch=2, amp=False, device="cpu", close_mosaic=0,
                                  project=str(tmp_path / "runs"), name="v12", workers=1))
    assert trainer.family == "yolo12" and isinstance(trainer.state.model, YOLOv12)
    result = trainer.train()
    save_dir = result["save_dir"]
    ckpt = load_checkpoint(f"{save_dir}/weights/best.pt")
    assert ckpt["family"] == "yolo12" and ckpt["scale"] == "n"
    assert "family: yolo12" in (tmp_path / "runs" / "v12" / "args.yaml").read_text()
    yolo = YOLO(f"{save_dir}/weights/best.pt", device="cpu")
    assert (yolo.family, yolo.scale, yolo.nc) == ("yolo12", "n", 2)
    assert isinstance(yolo._model, YOLOv12)
    # fine-tuning from it keeps the family
    again = Trainer(TrainConfig(model=f"{save_dir}/weights/best.pt", data=str(data_yaml),
                                epochs=1, imgsz=64, batch=2, amp=False, device="cpu",
                                project=str(tmp_path / "runs"), name="v12b", workers=1))
    assert again.family == "yolo12" and isinstance(again.state.model, YOLOv12)


def test_checkpoint_without_family_loads_as_yolo11(tmp_path):
    model = build_detector("yolo11n", nc=2, device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    path = tmp_path / "old.pt"
    torch.save({"format": CHECKPOINT_FORMAT, "model": sd, "ema": ema, "optimizer": {},
                "updates": 0, "epoch": 0, "fitness": 0.0, "nc": 2, "names": ["a", "b"],
                "scale": "n", "imgsz": 64}, path)
    yolo = YOLO(str(path), device="cpu")
    assert (yolo.family, yolo.scale, yolo.nc) == ("yolo11", "n", 2)
    assert all(torch.equal(v, sd[k]) for k, v in yolo._model.state_dict().items())

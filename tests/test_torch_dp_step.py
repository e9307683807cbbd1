"""The data-parallel train step on the CPU: two gloo ranks against one
process on the whole batch, and against the JAX step on a 2-device mesh.

The ranks are spawned processes that import this module: its top level
imports only torch, numpy, pytest and the port (JAX is imported inside the
tests that use it).

Tolerances:
- one ``BatchNorm`` on a split batch against the whole batch, f32: output
  and input gradient to 1e-5 relative, running statistics to 1e-6;
- the whole step (yolo11n, 128 px, B = 4 split 2 + 2, mosaic 1.0, mixup 0.5
  with partners that cross ranks) against one process, in float64: loss
  parts 1e-5 relative, every gradient rtol 1e-4 / atol 1e-5 elementwise (the
  JAX package's own DP tolerance, tests/test_parallel.py), BN statistics,
  parameters and EMA 1e-6. In f32 the one-process step is itself too
  sensitive for that bar: a 1e-7 relative change of the stem kernel alone
  moves 48 gradient tensors outside it (BatchNorm on 4x4 maps of a batch of
  four, through 100 layers); float64 leaves only the loss's f32 and bf16
  parts, so what remains measures the data-parallel arithmetic;
- against JAX on a 2-device mesh, f32: the tolerances of
  tests/test_torch_port_train.py (loss parts 1e-4, gradients 5e-2 of each
  tensor's largest entry, for the reasons stated there).
"""

import collections

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.models.blocks import BatchNorm
from deal_yolo_daya_tpu_torch.parallel import launch
from deal_yolo_daya_tpu_torch.parallel.dryrun import dp_steps
from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig, draw
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig
from tests.torch_deadline import LIMIT, _deadline, _deadline_module  # noqa: F401

IMGSZ, NC, BATCH = 128, 2, 4
AUG = DeviceAugConfig(mosaic=1.0, mixup=0.5)
SEEDS = (11, 12)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads in this process, one a rank while two ranks run: the
    tier-1 run shares the cores among six workers, and spinning OpenMP
    threads of several processes starve one another."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _close(got, want, rtol, what="", atol=1e-12):
    """max |got - want| <= rtol * max |want| + atol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + atol, f"{what}: max abs err {err:.3e} vs scale {scale:.3e}"


# ---------------------------------------------------------------- BatchNorm


def _bn_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (BATCH, 8, 5, 6)).astype(np.float32)   # NCHW
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    params = [rng.uniform(0.5, 1.5, 8), rng.uniform(-0.5, 0.5, 8), rng.uniform(-0.3, 0.3, 8),
              rng.uniform(0.5, 1.5, 8)]
    return x, w, [p.astype(np.float32) for p in params]


def _bn_rank(dp):
    """One train-mode BatchNorm forward and backward on this rank's rows (all
    of them without ``dp``) -> numpy (y, dx, d weight, d bias, running stats),
    the parameter gradients summed over the ranks."""
    x, w, (scale, bias, mean, var) = _bn_inputs()
    bn = BatchNorm(8)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in zip(
        ("weight", "bias", "running_mean", "running_var"), (scale, bias, mean, var))})
    bn.dp = dp
    rows = dp.rows(BATCH) if dp is not None else slice(None)
    xt = torch.from_numpy(x[rows]).requires_grad_()
    y = bn.train()(xt)
    (y * torch.from_numpy(w[rows])).sum().backward()
    gw, gb = bn.weight.grad, bn.bias.grad
    if dp is not None:
        dp.all_reduce_(gw)
        dp.all_reduce_(gb)
    return [t.detach().numpy().copy() for t in (y, xt.grad, gw, gb, bn.running_mean,
                                                 bn.running_var)]


def test_sync_batchnorm_matches_one_process_and_flax():
    one = _bn_rank(None)
    ranks = launch.run(_bn_rank, 2, ["cpu", "cpu"], timeout_s=LIMIT / 2)
    y = np.concatenate([ranks[0][0], ranks[1][0]])
    dx = np.concatenate([ranks[0][1], ranks[1][1]])
    np.testing.assert_allclose(y, one[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, one[1], rtol=1e-5, atol=1e-6)
    for r in ranks:  # the same parameter gradients and statistics on each rank
        np.testing.assert_allclose(r[2], one[2], rtol=1e-5)
        np.testing.assert_allclose(r[3], one[3], rtol=1e-5)
        np.testing.assert_allclose(r[4], one[4], atol=1e-6)
        np.testing.assert_allclose(r[5], one[5], atol=1e-6)

    import jax
    import jax.numpy as jnp
    from flax import linen as fnn

    x, w, (scale, bias, mean, var) = _bn_inputs()
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    xn, wn = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)

    def f(x, scale, bias):
        y, mutated = mod.apply({"params": {"scale": scale, "bias": bias},
                                "batch_stats": {"mean": mean, "var": var}},
                               x, mutable=["batch_stats"])
        return jnp.sum(y * wn), (y, mutated["batch_stats"])

    (_, (jy, jstats)), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        xn, scale, bias)
    np.testing.assert_allclose(y.transpose(0, 2, 3, 1), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[0][4], np.asarray(jstats["mean"]), atol=1e-6)
    np.testing.assert_allclose(ranks[0][5], np.asarray(jstats["var"]), atol=1e-6)
    _close(dx.transpose(0, 2, 3, 1), jgrads[0], 1e-5, "d x")
    _close(ranks[0][2], jgrads[1], 1e-5, "d scale")
    _close(ranks[0][3], jgrads[2], 1e-5, "d bias")


# ---------------------------------------------------------------- the step


def _raw_batch(seed=5, m=4):
    """Four grey-noise canvases with one to three 12-15 px boxes each, one a
    quadrant, red or green by class (the fixed batch of
    tests/test_torch_port_train.py, as a raw batch for the augmentation)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 1)).repeat(3, -1).astype(np.uint8)
    hw = np.full((BATCH, 2), IMGSZ, np.float32)
    boxes = np.zeros((BATCH, m, 4), np.float32)
    classes = np.zeros((BATCH, m), np.int32)
    mask = np.zeros((BATCH, m), bool)
    half = IMGSZ // 2
    for i in range(BATCH):
        for j, q in enumerate(rng.permutation(4)[:int(rng.integers(1, 4))]):
            w, h = (int(v) for v in rng.integers(12, 16, 2))
            x = half * (q % 2) + int(rng.integers(2, half - 2 - w))
            y = half * (q // 2) + int(rng.integers(2, half - 2 - h))
            c = int(rng.integers(0, NC))
            images[i, y:y + h, x:x + w] = (230, 30, 30) if c == 0 else (30, 230, 30)
            boxes[i, j], classes[i, j], mask[i, j] = (x, y, x + w, y + h), c, True
    return images, hw, boxes, classes, mask


def _start_weights():
    """A fresh yolo11n (nc 2) with box-head biases favouring DFL bin 1 (boxes
    ~20 px that overlap the small GTs)."""
    from deal_yolo_daya_tpu_torch.models.registry import make_detector
    from deal_yolo_daya_tpu_torch.models.yolo11 import init_weights

    sd = init_weights(make_detector("yolo11", "n", NC), 0).state_dict()
    for i in range(3):
        bias = torch.zeros((4, 16))
        bias[:, 1] = 6.0
        sd[f"23.cv2.{i}.2.bias"] = bias.reshape(-1)
    return sd


def _cfg():
    return TrainConfig(model="yolo11n", imgsz=IMGSZ, batch=BATCH, epochs=3, amp=False, seed=0,
                       max_boxes=16, lr0=1e-3, warmup_epochs=0)


@pytest.fixture(scope="module")
def dp_runs():
    """Two steps from the same weights, float64: one process on the whole
    batch, and two gloo ranks on 2 + 2 rows."""
    args = (_cfg(), NC, _start_weights(), _raw_batch(), SEEDS, AUG, None, 100, torch.float64)
    one = dp_steps(None, *args)
    ranks = launch.run(dp_steps, 2, ["cpu", "cpu"], args=args, timeout_s=LIMIT / 2)
    return one, ranks


def test_group_of_one_runs_its_collectives(dp_runs, monkeypatch):
    """A data-parallel group of one rank (the one-rank NCCL group that
    chip_smoke times against the one-card step) runs the step's collectives
    and synchronises every BatchNorm over itself, and its two steps equal
    one process at the bars of the two-rank tests; only the data group of
    one of a 1 x M mesh (``alone``) skips them."""
    from deal_yolo_daya_tpu_torch.parallel.sharding import DataParallel, ModelParallel

    one, _ = dp_runs
    calls = collections.Counter()

    def counted(name, orig):
        def call(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        return call

    for name in ("all_reduce", "all_gather"):
        monkeypatch.setattr(torch.distributed, name, counted(name, getattr(torch.distributed,
                                                                           name)))
    args = (_cfg(), NC, _start_weights(), _raw_batch(), SEEDS, AUG, None, 100, torch.float64)
    ranks = launch.start_local(1, ["cpu"])
    try:
        got = dp_steps(ranks.dp, *args)
        tp_data = DataParallel(0, 1, "cpu", mp=ModelParallel(0, 1, "cpu", None, first=0))
        assert not ranks.dp.alone and tp_data.alone
    finally:
        ranks.close()
    # per step: the raw-batch gather, the loss normaliser and the gradient
    # all-reduce at least, plus every BatchNorm's moments
    assert calls["all_reduce"] >= 2 * len(SEEDS) and calls["all_gather"] >= len(SEEDS), calls
    assert got["loss"]["num_fg"] == one["loss"]["num_fg"] > 0
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        assert got["loss"][k] == pytest.approx(one["loss"][k], rel=1e-5), k
    for name, g in one["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4, atol=1e-5, err_msg=name)
    for name, v in one["state"].items():
        _close(got["state"][name], v, 1e-6, name)


def test_mosaic_and_mixup_partners_cross_ranks():
    """The step's draws (the global batch's) send rank 0's rows to rank 1's
    sources and back, for the mosaic and for mixup."""
    crossed = {"mosaic": 0, "mixup": 0}
    for seed in SEEDS:
        d = draw(BATCH, torch.Generator().manual_seed(seed), AUG)
        for own in (range(0, 2), range(2, 4)):
            other = set(range(BATCH)) - set(own)
            crossed["mosaic"] += sum(int(p) in other for i in own for p in d.partners[i])
            crossed["mixup"] += sum(int(d.mix_j[i]) in other and bool(d.mix_u[i] < AUG.mixup)
                                    for i in own)
    assert crossed["mosaic"] > 0 and crossed["mixup"] > 0


def test_dp_step_loss_parts_match_one_process(dp_runs):
    one, ranks = dp_runs
    assert one["loss"]["num_fg"] > 0
    for r in ranks:  # every rank logs the global sums
        assert r["loss"]["num_fg"] == one["loss"]["num_fg"]
        for k in ("box_loss", "cls_loss", "dfl_loss"):
            assert r["loss"][k] == pytest.approx(one["loss"][k], rel=1e-5), k


def test_dp_step_gradients_match_one_process(dp_runs):
    one, ranks = dp_runs
    assert sorted(ranks[0]["grads"]) == sorted(one["grads"])
    for name, want in one["grads"].items():
        for r in ranks:
            np.testing.assert_allclose(r["grads"][name], want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_dp_step_state_matches_one_process(dp_runs):
    """Parameters and BN running statistics after the two updates, and the
    EMA: equal on the ranks, and to the one process's."""
    one, ranks = dp_runs
    for name, want in one["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][name], ranks[0]["state"][name])
        np.testing.assert_allclose(ranks[0]["state"][name], want, rtol=0, atol=1e-6,
                                   err_msg=name)
    for name, want in one["ema"].items():
        np.testing.assert_allclose(ranks[0]["ema"][name], want, rtol=0, atol=1e-6, err_msg=name)
    start = _start_weights()
    assert any(n.endswith("running_var") and not np.allclose(v, start[n].numpy())
               for n, v in one["state"].items())


# ---------------------------------------------------------------- against JAX


def _jax_two_device_step(images, boxes, classes, mask):
    """jax.value_and_grad of the JAX train step's loss on a 2-device mesh
    (batch sharded over data, parameters replicated), flax's two-pass batch
    variance as in tests/test_torch_port_train.py -> (variables, parts,
    grads) as numpy."""
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from deal_yolo_daya_tpu.models.registry import make_detector
    from deal_yolo_daya_tpu.parallel.mesh import create_mesh
    from deal_yolo_daya_tpu.parallel.sharding import batch_sharding, replicate_sharding
    from deal_yolo_daya_tpu.train.loss import LossConfig, detection_loss
    from deal_yolo_daya_tpu.train.trainer import scale_stem_kernel

    model = make_detector("yolo11", "n", NC, dtype=jnp.float32)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        bias = np.zeros((4, 16), np.float32)
        bias[:, 1] = 6.0
        params["detect"][f"box{i}_2"]["bias"] = bias.reshape(-1)
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])

    def loss_fn(params, stats, images, boxes, classes, mask):
        (box, cls), _ = model.apply({"params": scale_stem_kernel(params, 1.0 / 255.0),
                                     "batch_stats": stats}, images.astype(jnp.float32),
                                    train=True, mutable=["batch_stats"])
        return detection_loss(box, cls, classes, boxes, mask, (IMGSZ, IMGSZ), LossConfig(nc=NC))

    mesh = create_mesh(2)
    rep, data = replicate_sharding(mesh), batch_sharding(mesh)
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   in_shardings=(rep, rep, data, data, data, data))
    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass_stats  # while the program is traced
    try:
        (_, parts), grads = step(params, stats, images, boxes, classes, mask)
    finally:
        normalization._compute_stats = compute_stats
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    return ({"params": params, "batch_stats": stats}, {k: float(v) for k, v in parts.items()},
            to_np(grads))


def test_dp_step_matches_jax_two_device_mesh():
    """Two gloo ranks against the JAX step on a 2-device mesh, f32, on
    tests/test_torch_port_train.py's fixed batch and start weights."""
    from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
    from tests.test_torch_port_train import GRAD_ATOL, GRAD_RTOL, _fixed_batch

    batch = _fixed_batch()
    variables, parts, grads = _jax_two_device_step(*batch)
    args = (_cfg(), NC, state_dict_from_jax(variables), batch, (0,))
    ranks = launch.run(dp_steps, 2, ["cpu", "cpu"], args=args, timeout_s=LIMIT / 2)
    got = ranks[0]
    assert got["loss"]["num_fg"] == parts["num_fg"] > 0
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        assert got["loss"][k] == pytest.approx(parts[k], rel=1e-4), k
    want = state_dict_from_jax({"params": grads})
    assert sorted(got["grads"]) == sorted(want)
    for name, g in got["grads"].items():
        _close(g, want[name].numpy(), GRAD_RTOL, name, atol=GRAD_ATOL)

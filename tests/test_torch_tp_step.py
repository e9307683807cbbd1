"""The tensor-parallel train step and forward on the CPU: gloo ranks on a
1 x 2 and a 2 x 2 mesh (data x model) against one process and against the
data-parallel 2 x 1 ranks, and the sharded forward against the JAX
package's on a 4 x 2 mesh.

The ranks are spawned processes that import this module: its top level
imports only torch, numpy, pytest and the port (JAX is imported inside the
fixtures and tests that use it). One spawn a mesh, shared by the tests
through module fixtures.

Tolerances:
- two steps of yolo11n (64 px, B = 4, mosaic 1.0 and mixup 0.5, the convs of
  64 channels and more sharded: the Detect head's biased convs among them)
  in float64. The 1 x 2 ranks against one process, and the 2 x 2 ranks
  against the data-parallel 2 x 1 ranks on the same rows: every gathered
  gradient, parameter, BN statistic and EMA tensor to 1e-12 of its largest
  entry plus 1e-12 (a sharded conv's input gradient is summed in another
  order; what is left is float64 rounding), the loss parts to 1e-12
  relative. The 2 x 2 ranks against one process at
  tests/test_torch_dp_step.py's data-parallel bars (gradients rtol 1e-4 /
  atol 1e-5, state and EMA 1e-6, loss parts 1e-5 relative): splitting the
  batch moves the loss's f32 and bf16 parts, as that file states;
- the same with ``remat`` (1 x 2 against one process, both remat);
- the replicated parameters after the steps: bit-identical within each
  model group;
- the eval forward with the convs of 64 channels and more sharded, f32,
  against JAX's ``tp_param_shardings(min_channels=64)`` forward on
  ``create_mesh(4, 2)`` (JAX ``tests/test_parallel.py::
  test_tp_forward_matches_replicated``'s case and bar): atol 2e-5; and
  against the port's unsharded forward: atol 2e-5.
"""

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.models.blocks import ShardedConv2d, shard_convs
from deal_yolo_daya_tpu_torch.models.registry import make_detector
from deal_yolo_daya_tpu_torch.parallel import launch
from deal_yolo_daya_tpu_torch.parallel.dryrun import LOSS_PARTS, dp_steps
from deal_yolo_daya_tpu_torch.parallel.sharding import tp_param_shardings
from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig
from tests.torch_deadline import LIMIT, _deadline, _deadline_module  # noqa: F401

IMGSZ, NC, BATCH, MIN_CHANNELS = 64, 2, 4, 64
AUG = DeviceAugConfig(mosaic=1.0, mixup=0.5)
SEEDS = (21, 22)
STEP_TOL, FWD_ATOL = 1e-12, 2e-5
DP_LOSS_RTOL, DP_GRAD_TOL, DP_STATE_ATOL = 1e-5, (1e-4, 1e-5), 1e-6  # test_torch_dp_step.py's
FWD_IMGSZ = 32


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads in this process while the ranks run: the tier-1 run
    shares the cores among six workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= STEP_TOL * np.abs(want).max() + STEP_TOL, f"{what}: max abs err {err:.3e}"


def _raw_batch(seed=7, m=4):
    """Four grey-noise 64 px canvases with one to three 10-13 px red or
    green boxes each, one a quadrant, as a raw batch for the augmentation."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 1)).repeat(3, -1).astype(np.uint8)
    hw = np.full((BATCH, 2), IMGSZ, np.float32)
    boxes = np.zeros((BATCH, m, 4), np.float32)
    classes = np.zeros((BATCH, m), np.int32)
    mask = np.zeros((BATCH, m), bool)
    half = IMGSZ // 2
    for i in range(BATCH):
        for j, q in enumerate(rng.permutation(4)[:int(rng.integers(1, 4))]):
            w, h = (int(v) for v in rng.integers(10, 14, 2))
            x = half * (q % 2) + int(rng.integers(1, half - 1 - w))
            y = half * (q // 2) + int(rng.integers(1, half - 1 - h))
            c = int(rng.integers(0, NC))
            images[i, y:y + h, x:x + w] = (230, 30, 30) if c == 0 else (30, 230, 30)
            boxes[i, j], classes[i, j], mask[i, j] = (x, y, x + w, y + h), c, True
    return images, hw, boxes, classes, mask


def _start_weights():
    """A fresh yolo11n (nc 2), box-head biases favouring DFL bin 1."""
    from deal_yolo_daya_tpu_torch.models.yolo11 import init_weights

    sd = init_weights(make_detector("yolo11", "n", NC), 0).state_dict()
    for i in range(3):
        bias = torch.zeros((4, 16))
        bias[:, 1] = 6.0
        sd[f"23.cv2.{i}.2.bias"] = bias.reshape(-1)
    return sd


def _step_args(remat=False):
    cfg = TrainConfig(model="yolo11n", imgsz=IMGSZ, batch=BATCH, epochs=3, amp=False, seed=0,
                      max_boxes=16, lr0=1e-3, warmup_epochs=0, remat=remat)
    return (cfg, NC, _start_weights(), _raw_batch(), SEEDS, AUG, None, 100, torch.float64,
            MIN_CHANNELS)


def tp_forward(dp, state_dict, x):
    """The eval forward of yolo11n (nc 2) from ``state_dict`` on this rank's
    rows of the NHWC f32 ``x``, the convs of MIN_CHANNELS and more sharded
    over ``dp``'s model group (all of ``x`` and none sharded without ``dp``)
    -> (box and cls of the first level as NHWC numpy, the sharded names)."""
    model = make_detector("yolo11", "n", NC)
    model.load_state_dict(state_dict)
    sharded = {}
    if dp is not None:
        sharded = tp_param_shardings(model, dp.mp.world, MIN_CHANNELS)
        shard_convs(model, dp.mp, sharded)
    rows = dp.rows(len(x)) if dp is not None else slice(None)
    with torch.no_grad():
        box, cls = model.eval()(torch.from_numpy(x[rows]).permute(0, 3, 1, 2))
    return (box[0].permute(0, 2, 3, 1).numpy(), cls[0].permute(0, 2, 3, 1).numpy(),
            sorted(sharded))


def tp_rank(dp, step_args, fwd_args=None):
    """A rank of a fixture's run: the TP forward (when asked), then the steps."""
    out = {"forward": tp_forward(dp, *fwd_args) if fwd_args is not None else None,
           "steps": dp_steps(dp, *step_args)}
    out["global_rank"] = dp.global_rank
    out["model_rank"] = dp.mp.rank if dp.mp is not None else 0
    return out


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's yolo11n (nc 2) at 32 px: its variables, an input, and its
    forward replicated and with ``tp_param_shardings(min_channels=64)`` on a
    4 x 2 mesh (tests/test_parallel.py's case)."""
    import jax
    import jax.numpy as jnp

    from deal_yolo_daya_tpu.models.yolo11 import YOLO11
    from deal_yolo_daya_tpu.parallel.mesh import create_mesh
    from deal_yolo_daya_tpu.parallel.sharding import batch_sharding, tp_param_shardings as jax_tp

    model = YOLO11(nc=NC, scale="n")
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, FWD_IMGSZ, FWD_IMGSZ, 3)),
                                             train=False))(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(0.4, 0.2, (4, FWD_IMGSZ, FWD_IMGSZ, 3)).astype(np.float32)

    def fwd(params, images):
        box, cls = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               images, train=False)
        return box[0], cls[0]

    mesh = create_mesh(4, 2)
    param_sh = jax_tp(variables["params"], mesh, min_channels=MIN_CHANNELS)
    params_tp = jax.tree_util.tree_map(jax.device_put, variables["params"], param_sh)
    tp_box, tp_cls = jax.jit(fwd)(params_tp, jax.device_put(x, batch_sharding(mesh)))
    ref_box, ref_cls = jax.jit(fwd)(variables["params"], x)
    return {"variables": jax.device_get(variables), "x": x,
            "tp": (np.asarray(tp_box), np.asarray(tp_cls)),
            "replicated": (np.asarray(ref_box), np.asarray(ref_cls))}


@pytest.fixture(scope="module")
def runs(jax_forward):
    """One process, and gloo ranks on 1 x 2 and 2 x 2 meshes, from the same
    weights and batch; the 2 x 2 ranks also run the sharded forward."""
    from deal_yolo_daya_tpu_torch.models import state_dict_from_jax

    args = _step_args()
    fwd_args = (state_dict_from_jax(jax_forward["variables"]), jax_forward["x"])
    one = {"steps": dp_steps(None, *args)}
    one_remat = {"steps": dp_steps(None, *_step_args(remat=True))}
    return {"one": [one, one], "one_remat": [one_remat, one_remat],
            "1x2": launch.run(tp_rank, 2, ["cpu"] * 2, args=(args,), timeout_s=LIMIT / 2,
                              n_model=2),
            "1x2_remat": launch.run(tp_rank, 2, ["cpu"] * 2, args=(_step_args(remat=True),),
                                    timeout_s=LIMIT / 2, n_model=2),
            "2x1": launch.run(tp_rank, 2, ["cpu"] * 2, args=(args,), timeout_s=LIMIT / 2),
            "2x2": launch.run(tp_rank, 4, ["cpu"] * 4, args=(args, fwd_args), timeout_s=LIMIT / 2,
                              n_model=2),
            "fwd_one": tp_forward(None, *fwd_args)}


# (TP mesh, the run it equals to STEP_TOL): the model axis alone changes
# nothing but float64 summation order; under remat the backward recomputes
# the heavy blocks, their channel gathers included, in the same order on
# both ranks
PAIRS = [("1x2", "one"), ("2x2", "2x1"), ("1x2_remat", "one_remat")]


@pytest.mark.parametrize("mesh,ref", PAIRS)
def test_tp_step_loss_parts_match(runs, mesh, ref):
    assert runs["one"][0]["steps"]["loss"]["num_fg"] > 0
    for r, w in zip(runs[mesh], runs[ref] * 2):  # every rank logs the global sums
        got, want = r["steps"]["loss"], w["steps"]["loss"]
        assert got["num_fg"] == want["num_fg"]
        for k in LOSS_PARTS[:3]:
            assert got[k] == pytest.approx(want[k], rel=STEP_TOL), k


@pytest.mark.parametrize("mesh,ref", PAIRS)
@pytest.mark.parametrize("what", ["grads", "state", "ema"])
def test_tp_step_whole_tensors_match(runs, mesh, ref, what):
    """The first step's gathered gradients, and the parameters, BN
    statistics and EMA after two, on every rank: whole, one-process keys
    and shapes, equal to the reference run's (rank by data index)."""
    for r in runs[mesh]:
        want = runs[ref][r["global_rank"] // 2]["steps"][what]
        got = r["steps"][what]
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        for name, w in want.items():
            _close(got[name], w, f"rank {r['global_rank']} {what} {name}")


def test_tp_2x2_step_matches_one_process_at_dp_bars(runs):
    one = runs["one"][0]["steps"]
    for r in runs["2x2"]:
        got = r["steps"]
        assert got["loss"]["num_fg"] == one["loss"]["num_fg"]
        for k in LOSS_PARTS[:3]:
            assert got["loss"][k] == pytest.approx(one["loss"][k], rel=DP_LOSS_RTOL), k
        for name, w in one["grads"].items():
            np.testing.assert_allclose(got["grads"][name], w, rtol=DP_GRAD_TOL[0],
                                       atol=DP_GRAD_TOL[1], err_msg=name)
        for what in ("state", "ema"):
            for name, w in one[what].items():
                np.testing.assert_allclose(got[what][name], w, rtol=0, atol=DP_STATE_ATOL,
                                           err_msg=name)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x2_remat"])
def test_tp_replicated_parameters_bit_identical_in_model_group(runs, mesh):
    ranks = runs[mesh]
    sharded = set(ranks[0]["steps"]["sharded"])
    assert len(sharded) == 67 and "23.cv2.0.2.weight" in sharded  # a biased Detect conv
    for d in range(len(ranks) // 2):
        first, second = ranks[2 * d], ranks[2 * d + 1]
        assert (first["model_rank"], second["model_rank"]) == (0, 1)
        rep = first["steps"]["replicated"]
        assert sharded.isdisjoint(rep) and len(rep) > 100
        for name, v in rep.items():
            assert np.array_equal(second["steps"]["replicated"][name], v), name


def test_tp_forward_matches_jax_and_replicated(runs, jax_forward):
    """The 2 x 2 ranks' sharded forward, rows gathered in data order, against
    the JAX TP forward on a 4 x 2 mesh and the port's unsharded forward."""
    ranks = runs["2x2"]
    names = ranks[0]["forward"][2]
    assert len(names) == 67 and all(r["forward"][2] == names for r in ranks)
    # the two model ranks of a data index compute the same rows
    for d in range(2):
        for a, b in zip(ranks[2 * d]["forward"][:2], ranks[2 * d + 1]["forward"][:2]):
            np.testing.assert_array_equal(a, b)
    box = np.concatenate([ranks[0]["forward"][0], ranks[2]["forward"][0]])
    cls = np.concatenate([ranks[0]["forward"][1], ranks[2]["forward"][1]])
    jax_box, jax_cls = jax_forward["tp"]
    np.testing.assert_allclose(box, jax_box, atol=FWD_ATOL)
    np.testing.assert_allclose(cls, jax_cls, atol=FWD_ATOL)
    np.testing.assert_allclose(jax_forward["replicated"][0], jax_box, atol=FWD_ATOL)
    one_box, one_cls, _ = runs["fwd_one"]
    np.testing.assert_allclose(box, one_box, atol=FWD_ATOL)
    np.testing.assert_allclose(cls, one_cls, atol=FWD_ATOL)


class _FakeGroup:
    """A model group's place (``rank`` of ``world``) without a process
    group: what building a ``ShardedConv2d`` reads."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def own(self, n):
        c = n // self.world
        return slice(self.rank * c, (self.rank + 1) * c)


@pytest.mark.parametrize("groups", [1, 32])
def test_sharded_conv_module_layout(groups):
    """A ShardedConv2d of a (32 -> 32, 3x3) conv over 2 ranks keeps 16
    output channels (and, depthwise, 16 input channels and 16 groups), the
    whole bias, and ``whole()`` is the plain conv's shape."""
    conv = torch.nn.Conv2d(32, 32, 3, 2, 1, groups=groups, bias=True)
    sharded = ShardedConv2d(conv, _FakeGroup(1, 2))
    assert sharded.weight.shape == (16, 32 // groups, 3, 3)
    assert sharded.groups == max(groups // 2, 1) and sharded.bias.shape == (32,)
    assert sharded.in_channels == (16 if groups > 1 else 32)
    whole = sharded.whole()
    assert whole.weight.shape == conv.weight.shape and whole.groups == groups
    assert (whole.stride, whole.padding) == (conv.stride, conv.padding)
    with pytest.raises(ValueError, match="does not split"):
        ShardedConv2d(torch.nn.Conv2d(30, 30, 3, groups=3), _FakeGroup(0, 2))

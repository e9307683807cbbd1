"""The train step the step program runs (``train/step_graph.py``) and the
device-scalar optimizer under it, on the CPU, where the program runs its
captured callable eagerly.

- The foreach optimizer reading lr, momentum and Adam's corrections from a
  device vector against ``torch.optim.SGD``/``Adam`` with the same Python
  floats set before each step (the port's previous path), over warm-up
  steps where lr and momentum move: within 2 ulps of the parameters
  (``foreach`` rounds lr * d once, ``add(alpha=-lr)`` may fuse); and each
  step's update against the JAX optimizer's within 1e-4 of its largest
  entry.
- The auto K of ``steps_per_dispatch`` against the JAX Trainer's for 1 to
  64 batches.
- One epoch of the port's Trainer through the program at K = 2 against the
  JAX Trainer's chunked dispatch (``steps_per_dispatch=2``, one
  ``lax.scan`` of two gather -> augment -> train steps): the loss sums
  within 5e-4 relative, the parameters', EMA's and BN statistics' moves
  within 5e-2 of each tensor's largest move, the tolerances of
  ``tests/test_torch_port_trainer.py`` and for its reasons (XLA's jit keeps
  f32 across the assigner's bf16 metric).
- The program against the port's own K = 1 eager loop: bit for bit, with
  and without gradient accumulation (the micro-step and update variants).
- The launch counters under a graph (``_build.count_launch``,
  ``GraphLaunches``), with the capture stood in for: exact counts.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deal_yolo_daya_tpu.train import optimizer as jax_opt
from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.train import optimizer as port_opt
from deal_yolo_daya_tpu_torch.train.step_graph import StepProgram, auto_steps_per_dispatch
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.test_data import make_dataset
from tests.test_torch_port_trainer import _config, _start_weights, _write_dataset

LOSS_RTOL = 5e-4
DELTA_RTOL = 5e-2
OPT_ULPS = 2 * np.finfo(np.float32).eps
# optax's Adam and the port's round the moments in other orders: an update
# lands up to 4.8e-5 of its largest entry from JAX's (SGD: 2e-6)
JAX_UPDATE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and PyTorch's OpenMP threads spin-wait when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Net(torch.nn.Module):
    """A conv (decayed kernel, bias), a BatchNorm-like weight and a head."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.scale = torch.nn.Parameter(torch.ones(4))
        self.head = torch.nn.Conv2d(4, 2, 1, bias=False)


def _fill(model, rng):
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 1, tuple(p.shape)).astype(np.float32)))


def _hyper(opt, step):
    h = torch.zeros(port_opt.N_HYPER)
    for col, v in opt.hyper_row(step).items():
        h[col] = v
    return h


def _reference(name, model, cfg):
    """The previous path: torch.optim over the three groups, lr and
    momentum set as Python floats before every step."""
    groups = port_opt.param_groups(model)
    decay = cfg.weight_decay if name != "adam" else 0.0
    spec = [{"params": groups["decay"], "weight_decay": decay, "schedule": "main"},
            {"params": groups["no_decay"], "weight_decay": 0.0, "schedule": "main"},
            {"params": groups["bias"], "weight_decay": 0.0, "schedule": "bias"}]
    if name == "sgd":
        opt = torch.optim.SGD(spec, lr=0.0, momentum=cfg.momentum, nesterov=True)
    else:
        opt = torch.optim.Adam(spec, lr=0.0, betas=(cfg.momentum, 0.999), eps=1e-8)
    lr = {"main": port_opt.lr_schedule(cfg), "bias": port_opt.lr_schedule(cfg, cfg.warmup_bias_lr)}
    mom = port_opt.momentum_schedule(cfg)

    def step(i):
        for g in opt.param_groups:
            g["lr"] = lr[g["schedule"]](i)
            if name == "sgd":
                g["momentum"] = mom(i)
        opt.step()

    return step


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_device_scalar_optimizer_matches_torch_optim(name):
    """Six steps of a 4-step warm-up (lr and momentum move every step)."""
    cfg = port_opt.OptimizerConfig(name=name, lr0=0.02, warmup_epochs=2, epochs=4,
                                   steps_per_epoch=2, weight_decay=1e-2)
    rng = np.random.default_rng(3)
    ours, ref = _Net(), _Net()
    _fill(ours, rng)
    ref.load_state_dict(ours.state_dict())
    opt = port_opt.Optimizer(cfg, ours)
    ref_step = _reference(name, ref, cfg)
    for i in range(6):
        grads = [rng.normal(0, 1, tuple(p.shape)).astype(np.float32) for p in ours.parameters()]
        for p, q, g in zip(ours.parameters(), ref.parameters(), grads):
            p.grad.copy_(torch.from_numpy(g))
            q.grad = torch.from_numpy(g.copy())
        opt.step(_hyper(opt, i))
        ref_step(i)
        for (n, p), q in zip(ours.named_parameters(), ref.parameters()):
            tol = OPT_ULPS * float(q.abs().max()) + 1e-12
            assert float((p - q).abs().max()) <= tol, (name, n, i)
    # the optimizer's state is where torch.optim keeps it
    state = opt.state_dict()["state"]
    assert set(state[0]) == ({"exp_avg", "exp_avg_sq"} if name != "sgd" else {"momentum_buffer"})


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_device_scalar_optimizer_matches_jax(name):
    """Each of six warm-up steps from the same parameters (the port's set to
    JAX's after each): every tensor's update within JAX_UPDATE_RTOL of its
    largest entry."""
    cfg = dict(name=name, lr0=0.02, warmup_epochs=2, epochs=4, steps_per_epoch=2,
               weight_decay=1e-2)
    rng = np.random.default_rng(4)
    model = _Net()
    _fill(model, rng)
    leaves = dict(model.named_parameters())
    paths = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
             "scale": ("bn", "scale"), "head.weight": ("head", "kernel")}

    def tree(values):  # the JAX tree: kernels decay, "bias" leaves take the bias schedule
        out = {}
        for n, (m, k) in paths.items():
            out.setdefault(m, {})[k] = jnp.asarray(values[n])
        return out

    params = tree({n: p.detach().numpy() for n, p in leaves.items()})
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**cfg), params)
    state = tx.init(params)
    opt = port_opt.Optimizer(port_opt.OptimizerConfig(**cfg), model)
    for i in range(6):
        grads = {n: rng.normal(0, 1, tuple(p.shape)).astype(np.float32) for n, p in leaves.items()}
        updates, state = tx.update(tree(grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        old = {n: p.detach().clone() for n, p in leaves.items()}
        for n, p in leaves.items():
            p.grad.copy_(torch.from_numpy(grads[n]))
        opt.step(_hyper(opt, i))
        for n, (m, k) in paths.items():
            want = np.asarray(updates[m][k])
            got = (leaves[n].detach() - old[n]).numpy()
            assert np.abs(got - want).max() <= JAX_UPDATE_RTOL * np.abs(want).max() + 1e-12, \
                (name, n, i)
            with torch.no_grad():
                leaves[n].copy_(torch.from_numpy(np.array(params[m][k])))


@pytest.mark.parametrize("k", [None, 1, 3, 8])
def test_auto_steps_per_dispatch_matches_jax(k):
    from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer

    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(steps_per_dispatch=k),
                                 single_device=True)
    for n in range(1, 65):
        assert auto_steps_per_dispatch(k, n) == JaxTrainer.steps_per_dispatch(fake, n), (k, n)


# ---------------------------------------------------------------- against JAX's chunked dispatch


def _deltas(got, want, init, what):
    """Each tensor's move from ``init``: got's within DELTA_RTOL of want's
    largest move (plus the f32 resolution of the values)."""
    eps = 4 * np.finfo(np.float32).eps
    for name, w in want.items():
        move = (w - init[name]).numpy()
        d = (got[name].cpu() - init[name]).numpy()
        floor = eps * float(np.abs(init[name].numpy()).max()) + 1e-9
        assert np.abs(d - move).max() <= DELTA_RTOL * np.abs(move).max() + floor, (what, name)


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """One epoch (2 steps, one K = 2 dispatch) of the JAX Trainer's chunked
    path and of the port's step program, from the same weights."""
    from flax.linen import normalization

    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("port_chunked")
    data_yaml = _write_dataset(tmp / "ds")
    jt = JaxTrainer(_config(JaxTrainConfig, data_yaml, tmp / "jax", "run", device="1",
                            steps_per_dispatch=2, val=False))
    start = _start_weights({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, start["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, start["batch_stats"]),
        ema_params=jax.tree_util.tree_map(jnp.asarray, start["params"]))
    assert jt.cfg.cache == "device" and jt.steps_per_dispatch(2) == 2

    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass_stats  # while the programs are traced
    try:
        loss_acc = jt.zero_loss_acc()
        idx = np.stack(list(jt.train_loader.epoch_indices(0)))
        seeds = jnp.asarray(np.arange(2, dtype=np.uint32))
        jstate, _, loss_acc = jt.train_chunk(jt.state, loss_acc, *jt._ensure_device_cache(),
                                             jnp.asarray(idx, jnp.int32), seeds, False)
    finally:
        normalization._compute_stats = compute_stats
    jax_record = {"params": state_dict_from_jax({"params": jax.device_get(jstate.params)}),
                  "ema": state_dict_from_jax({"params": jax.device_get(jstate.ema_params)}),
                  "stats": state_dict_from_jax({"batch_stats": jax.device_get(
                      jstate.batch_stats)}),
                  "acc": {k: float(v) for k, v in loss_acc.items()},
                  "initial": state_dict_from_jax(start)}

    pt = Trainer(_config(TrainConfig, data_yaml, tmp / "port", "run", device="cpu",
                         steps_per_dispatch=2, val=False), init_state_dict=state_dict_from_jax(start))
    calls = []
    run = StepProgram.run

    def counted(self, idx, seeds):
        calls.append(len(seeds))
        return run(self, idx, seeds)

    StepProgram.run = counted
    try:
        pt.train()
    finally:
        StepProgram.run = run
    return {"jax": jax_record, "port": pt, "calls": calls}


def test_program_took_the_epoch_in_one_dispatch(chunked):
    assert chunked["calls"] == [2] and chunked["port"].state.updates == 2


def test_program_loss_sums_match_jax_chunked(chunked):
    want, got = chunked["jax"]["acc"], chunked["port"].state.loss_acc
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert float(got[k]) == pytest.approx(w, rel=LOSS_RTOL, abs=1e-6), k
    assert want["num_fg"] > 0 and want["box_loss"] > 0


@pytest.mark.parametrize("part", ["params", "ema"])
def test_program_parameters_and_ema_match_jax_chunked(chunked, part):
    st = chunked["port"].state
    got = dict(st.model.named_parameters()) if part == "params" else st.ema_state_dict()
    got = {k: v.detach() for k, v in got.items()}
    _deltas(got, chunked["jax"][part], chunked["jax"]["initial"], part)


def test_program_bn_statistics_match_jax_chunked(chunked):
    want = chunked["jax"]["stats"]
    got = chunked["port"].state.model.state_dict()
    assert want and set(want) <= set(got)
    _deltas(got, want, chunked["jax"]["initial"], "bn statistics")


# ---------------------------------------------------------------- against the port's eager loop


def _train(tmp_path, data_yaml, name, **kw):
    cfg = TrainConfig(**{**dict(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=64,
                                batch=4, amp=False, close_mosaic=0, val=False, device="cpu",
                                project=str(tmp_path / "runs"), name=name, seed=0,
                                max_boxes=16, warmup_epochs=0.5, workers=1), **kw})
    t = Trainer(cfg)
    t.train()
    return t


@pytest.mark.parametrize("extra", [{}, {"nbs": 8}], ids=["plain", "accumulate2"])
def test_program_equals_the_eager_loop_bit_for_bit(tmp_path, extra):
    """20 images at batch 4: K = 2 runs two dispatches and one eager
    remainder step; K = 1 runs five eager steps. With nbs 8 (accumulate 2)
    the program takes the micro-step and the update graphs in turn."""
    data_yaml = make_dataset(tmp_path, n_train=20, n_val=4, imgsz=64, nc=2)
    a = _train(tmp_path, data_yaml, "k2", steps_per_dispatch=2, **extra)
    b = _train(tmp_path, data_yaml, "k1", steps_per_dispatch=1, **extra)
    assert a._uses_device_cache() and a.state.updates == b.state.updates == 5
    sa, sb = a.state.state(), b.state.state()
    for part in ("model", "ema"):
        for k, v in sb[part].items():
            assert torch.equal(sa[part][k], v), (part, k)
    for i, s in sb["optimizer"]["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(sa["optimizer"]["optimizer"]["state"][i][k], v), (i, k)
    assert (sa["optimizer"]["micro"], sa["optimizer"]["updates"]) == \
        (sb["optimizer"]["micro"], sb["optimizer"]["updates"])
    for k, v in b.state.loss_acc.items():
        assert torch.equal(a.state.loss_acc[k], v), k


def test_program_buffers_stay_put_and_the_slot_wraps(tmp_path):
    """The buffers a graph reads by address (the indices, the draws and the
    state's hyperparameter vector) keep their storage across dispatches and
    hold the last step's values, the program is kept while the augmentation
    is, and a close_mosaic flip makes a program of its own."""
    data_yaml = make_dataset(tmp_path, n_train=16, n_val=4, imgsz=64, nc=2)
    t = _train(tmp_path, data_yaml, "k4", steps_per_dispatch=4, epochs=0)
    t._ensure_device_cache()
    prog = t.step_program()
    bufs = lambda: (prog.idx, prog.state.hyper, *prog.draws)  # noqa: E731
    ptrs = [b.data_ptr() for b in bufs()]
    idx = np.stack(list(t.train_loader.epoch_indices(0)))
    for _ in range(2):
        prog.run(idx, [11, 12, 13, 14])
        assert torch.equal(prog.idx, torch.from_numpy(idx[-1]))
    assert [b.data_ptr() for b in bufs()] == ptrs and t.state.updates == 8
    assert t.step_program() is prog
    t.train_loader.mosaic_off = True
    other = t.step_program()
    assert other is not prog and t._program is other and other.aug_cfg.mosaic == 0.0
    with pytest.raises(ValueError, match="2 index rows for 1 seeds"):
        other.run(idx[:2], [1])


# ---------------------------------------------------------------- launch counts under graphs


def test_graph_launches_count_at_each_replay(monkeypatch):
    """A wrapper's launch on a capturing stream moves no counter, its graph
    adds it at each replay; outside a capture it counts at once; a capture
    on a stream no ``GraphLaunches`` records raises."""
    from deal_yolo_daya_tpu_torch.ops.kernels import _build
    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa

    name = aa.__name__
    monkeypatch.setattr(aa, "launches", 0)
    monkeypatch.setattr(aa, "bwd_launches", 0)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    streams = [types.SimpleNamespace(cuda_stream=7)]
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: streams[0])
    _build.count_launch(name)
    assert (aa.launches, aa.bwd_launches) == (1, 0)
    graph = _build.GraphLaunches()
    capturing[0] = True
    with graph.capture():
        _build.count_launch(name)
        _build.count_launch(name, "bwd_launches")
        _build.count_launch(name)
        streams[0] = types.SimpleNamespace(cuda_stream=8)  # another stream's capture
        with pytest.raises(RuntimeError, match="outside GraphLaunches"):
            _build.count_launch(name)
        streams[0] = types.SimpleNamespace(cuda_stream=7)
    assert (aa.launches, aa.bwd_launches) == (1, 0) and not _build._capturing
    with pytest.raises(RuntimeError, match="outside GraphLaunches"):
        _build.count_launch(name)
    capturing[0] = False
    for _ in range(3):
        graph.replayed()
    assert (aa.launches, aa.bwd_launches) == (7, 3)

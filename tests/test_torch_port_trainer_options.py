"""The Trainer's options this slice ports, on the CPU: ``remat``,
``profile_steps``, ``async_ckpt``, ``batch=-1`` (``fit_and_pick``) and
``device_augment=False``, each held to the JAX package or to the port's
own path without the option.

Tolerances:
- ``remat`` gradients (f32, 64 px, batch 2, a fixed linear loss of the
  head outputs) against ``remat=False``: bit for bit on the CPU (the same
  ops recomputed); against the JAX package's ``remat=True`` within 5e-3 of
  each gradient's largest entry plus 1e-8 of the largest gradient of all
  (f32 sums through 23 modules, where a few BN bias gradients cancel to
  ~0; flax's two-pass batch variance, as in
  ``tests/test_torch_port_train.py``); the BN running
  statistics after a remat step equal a plain step's (the recomputation
  does not move them twice);
- ``profile_steps``, ``async_ckpt``: bit for bit against the same run
  without the option;
- ``fit_and_pick``: equal to the JAX package's on a grid of inputs; the
  ``batch=-1`` probe's path and its accounting, exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deal_yolo_daya_tpu.train.autobatch import fit_and_pick as jax_fit_and_pick
from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.models.registry import make_detector
from deal_yolo_daya_tpu_torch.train import async_ckpt
from deal_yolo_daya_tpu_torch.train.autobatch import fit_and_pick, suggest_batch
from deal_yolo_daya_tpu_torch.train.trainer import (TrainConfig, Trainer, load_checkpoint)
from tests.test_data import make_dataset
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

REMAT_JAX_RTOL = 5e-3   # of each gradient's largest entry (2.1e-3 measured)
REMAT_JAX_ATOL = 1e-8   # of the largest gradient of all: the ~0 ones (C2PSA's BN biases)
IMGSZ, NC, B = 64, 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and PyTorch's OpenMP threads spin-wait when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(tmp_path, name, data_yaml, **kw):
    cfg = TrainConfig(**{**dict(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=64,
                                batch=4, amp=False, close_mosaic=0, device="cpu", seed=0,
                                project=str(tmp_path / "runs"), name=name, max_boxes=16,
                                warmup_epochs=0.5, workers=1), **kw})
    return Trainer(cfg)


def _same_state(a, b):
    sa, sb = a.state.state(), b.state.state()
    for part in ("model", "ema"):
        for k, v in sb[part].items():
            assert torch.equal(sa[part][k], v), (part, k)


# ---------------------------------------------------------------- remat


@pytest.fixture(scope="module")
def remat_case():
    """A JAX yolo11n with remat, its variables, an input, the loss weights
    and JAX's gradients of the loss at train=True."""
    from flax.linen import normalization

    from deal_yolo_daya_tpu.models.registry import make_detector as jax_make_detector

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, IMGSZ, IMGSZ, 3)).astype(np.float32)
    model = jax_make_detector("yolo11", "n", NC, remat=True)
    variables = jax.jit(lambda k: model.init(k, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(0))
    shapes = [(B, IMGSZ // s, IMGSZ // s, c) for s in (8, 16, 32) for c in (64, NC)]
    weights = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]

    def loss(params):
        (box, cls), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        outs = [o for pair in zip(box, cls) for o in pair]
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass_stats
    try:
        grads = jax.jit(jax.grad(loss))(variables["params"])
    finally:
        normalization._compute_stats = compute_stats
    return {"x": x, "weights": weights, "variables": jax.device_get(variables),
            "grads": state_dict_from_jax({"params": jax.device_get(grads)})}


def _port_grads(case, remat):
    model = make_detector("yolo11", "n", NC, remat=remat)
    model.load_state_dict(state_dict_from_jax(case["variables"]), strict=True)
    model.train()
    box, cls = model(torch.from_numpy(case["x"]).permute(0, 3, 1, 2))
    outs = [o for pair in zip(box, cls) for o in pair]
    loss = sum((o * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
               for o, w in zip(outs, case["weights"]))
    loss.backward()
    return ({n: p.grad for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items() if "running_" in k})


def test_remat_gradients_equal_the_plain_ones(remat_case):
    (g_r, stats_r), (g_p, stats_p) = _port_grads(remat_case, True), _port_grads(remat_case, False)
    for n, g in g_p.items():
        assert torch.equal(g_r[n], g), n
    for k, v in stats_p.items():  # moved once, not again by the recomputation
        assert torch.equal(stats_r[k], v), k


def test_remat_gradients_match_jax_remat(remat_case):
    got, _ = _port_grads(remat_case, True)
    want = remat_case["grads"]
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for n, w in want.items():
        w = w.numpy()
        err = np.abs(got[n].numpy() - w).max()
        assert err <= REMAT_JAX_RTOL * np.abs(w).max() + REMAT_JAX_ATOL * scale, (n, err)


def test_remat_recomputes_the_heavy_blocks_only_in_training(monkeypatch):
    from deal_yolo_daya_tpu_torch.models import blocks

    calls = []
    original = blocks.checkpoint

    def counted(fn, *args, **kw):
        calls.append(type(fn).__name__)
        return original(fn, *args, **kw)

    monkeypatch.setattr(blocks, "checkpoint", counted)
    model = make_detector("yolo11", "n", NC, remat=True).train()
    x = torch.zeros((1, 3, 64, 64))
    model(x)
    assert sorted(set(calls)) == ["C2PSA", "C3k2", "DetectHead", "SPPF"]
    assert calls.count("C3k2") == 8
    calls.clear()
    with torch.no_grad():
        model(x)
    model.eval()
    model(x)
    assert calls == []


def test_trainer_threads_remat_to_the_model(tmp_path):
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "remat", data_yaml, remat=True, steps_per_dispatch=1)
    assert t.state.model.remat
    plain = _small(tmp_path, "plain", data_yaml, steps_per_dispatch=1)
    t.train()
    plain.train()
    _same_state(t, plain)


# ---------------------------------------------------------------- profile_steps


def test_profile_steps_writes_a_trace_and_changes_nothing(tmp_path):
    """profile_steps=2 traces steps 1-2 of the first epoch through the step
    program (K auto resolves to 4 for the 4 batches; the profiled epoch's
    dispatch is cut at steps 1 and 3), and trains as the same run without
    it does."""
    data_yaml = make_dataset(tmp_path, n_train=16, n_val=4, imgsz=64, nc=2)
    a = _small(tmp_path, "prof", data_yaml, profile_steps=2, epochs=2, val=False)
    b = _small(tmp_path, "noprof", data_yaml, epochs=2, val=False)
    assert a.steps_per_dispatch(len(a.train_loader)) == 4
    a.train()
    b.train()
    trace = a.run.path / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert '"traceEvents"' in trace.read_text()[:4096]
    assert not (b.run.path / "profile").exists()
    _same_state(a, b)


# ---------------------------------------------------------------- async_ckpt


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    data_yaml = make_dataset(tmp, n_train=8, n_val=4, imgsz=64, nc=2)
    runs = {}
    for name, flag in (("async", True), ("sync", False)):
        t = _small(tmp, name, data_yaml, async_ckpt=flag, epochs=2, save_period=1)
        t.train()
        runs[name] = t
    return {"tmp": tmp, "data_yaml": data_yaml, **runs}


@pytest.mark.parametrize("tag", ["last", "best", "epoch1", "epoch2"])
def test_async_checkpoints_equal_the_synchronous_ones(ckpt_runs, tag):
    a = load_checkpoint(ckpt_runs["async"].run.path / "weights" / f"{tag}.pt")
    s = load_checkpoint(ckpt_runs["sync"].run.path / "weights" / f"{tag}.pt")
    for part in ("model", "ema"):
        assert a[part].keys() == s[part].keys()
        for k, v in s[part].items():
            assert torch.equal(a[part][k], v), (tag, part, k)
    for i, st in s["optimizer"]["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(a["optimizer"]["optimizer"]["state"][i][k], v), (tag, i, k)
    assert (a["epoch"], a["updates"], a["fitness"]) == (s["epoch"], s["updates"], s["fitness"])
    assert not list((ckpt_runs["async"].run.path / "weights").glob("*.tmp"))


@pytest.mark.parametrize("tag", ["last", "best"])
def test_resume_from_async_checkpoint_equals_resume_from_sync(ckpt_runs, tag):
    """A third epoch from each run's checkpoint."""
    tmp, data_yaml = ckpt_runs["tmp"], ckpt_runs["data_yaml"]
    resumed = []
    for name in ("async", "sync"):
        path = ckpt_runs[name].run.path / "weights" / f"{tag}.pt"
        t = _small(tmp, f"resume_{tag}_{name}", data_yaml, epochs=3, resume=str(path))
        assert t.start_epoch == load_checkpoint(path)["epoch"] + 1
        t.train()
        resumed.append(t)
    _same_state(*resumed)


def test_a_writer_error_is_raised_at_the_flush(tmp_path, monkeypatch):
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "broken", data_yaml, val=False)

    def broken_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(async_ckpt.torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        t.train()
    t.flush_checkpoints()  # raised once; the writer stays usable


def test_writer_flushes_a_slot_still_being_written(tmp_path):
    """A second save of the same slot (last, or epochN after epochM) waits
    for the first: both files end whole, in order."""
    w = async_ckpt.CheckpointWriter()
    order = []
    for i in range(3):
        w.save(tmp_path / f"epoch{i}.pt", {"x": torch.full((4,), float(i))},
               after=lambda i=i: order.append(i))
    w.close()
    assert order == [0, 1, 2]
    assert [float(torch.load(tmp_path / f"epoch{i}.pt")["x"][0]) for i in range(3)] == [0, 1, 2]


# ---------------------------------------------------------------- batch=-1


@pytest.mark.parametrize("limit", [4e9, 16e9, 80e9, 2e8])
def test_fit_and_pick_matches_jax(limit):
    for probe in ((0.5e9, 0.9e9), (2e9, 3.5e9), (7.84e9, 6.10e9), (1e9, 1e9), (1e8, 3e9)):
        for fraction, cap in ((0.8, 1024), (0.5, 64)):
            assert fit_and_pick((4, 8), probe, limit, fraction, cap) == \
                jax_fit_and_pick((4, 8), probe, limit, fraction, cap), (probe, fraction, cap)
    with pytest.raises(ValueError):
        fit_and_pick((8, 4), (1.0, 2.0), limit)


def test_batch_minus_one_on_the_cpu_takes_16(tmp_path, capsys):
    """The CPU reports no device memory: batch 16, with the JAX message."""
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "auto", data_yaml, batch=-1)
    assert t.cfg.batch == 16 and t.train_loader.batch_size == 16
    assert "memory probe unavailable" in capsys.readouterr().out
    assert suggest_batch(lambda: None, 64, torch.device("cpu"), log=lambda s: None) == 16


@pytest.mark.parametrize("kw, graphed", [({}, True), ({"steps_per_dispatch": 1}, False),
                                         ({"device_augment": False}, False)],
                         ids=["graphed", "k1", "host_augment"])
def test_batch_minus_one_probes_the_path_the_trainer_takes(tmp_path, monkeypatch, kw, graphed):
    """batch=-1 hands the probe the Trainer's path: the step program when
    the device cache takes the graph, the device cache's bytes kept out of
    the limit, and a validation batch on the probe's own state."""
    from deal_yolo_daya_tpu_torch.train import trainer as trainer_mod

    seen = {}

    def fake_suggest(make_state, imgsz, device, **k):
        seen.update(k, state=make_state())
        return 4

    monkeypatch.setattr(trainer_mod, "suggest_batch", fake_suggest)
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "auto", data_yaml, batch=-1, **kw)
    assert t.cfg.batch == 4 and seen["graphed"] is graphed
    assert seen["reserve_bytes"] == (t._device_cache_bytes() if "device_augment" not in kw else 0)
    assert t._device_cache_bytes() == 12 * (64 * 64 * 3 + 16 * 24 + 16)
    st = seen["state"]
    images = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    boxes = torch.tensor([[[8.0, 8.0, 40.0, 40.0]]]).repeat(2, 1, 1)
    inv = torch.tensor([[1.0, 0.0, 0.0, 64.0, 64.0]]).repeat(2, 1)
    det, *_ = seen["evaluate"](st, images, boxes, torch.zeros((2, 1), dtype=torch.int32),
                               torch.ones((2, 1), dtype=torch.bool), inv)
    assert det[0].shape[0] == 2 and st is not t.state


def test_probe_takes_the_larger_of_the_steps_and_validation(monkeypatch):
    """``probe_path_bytes`` on the CPU with the card's memory counters
    stood in for: the step program's warm-up steps and its first replay
    (WARMUP_RUNS + 1 real steps), two validation batches, and the larger of
    the steps' peak and the reserved bytes under validation plus its peak."""
    from deal_yolo_daya_tpu_torch.train import autobatch
    from deal_yolo_daya_tpu_torch.train.step_graph import WARMUP_RUNS
    from deal_yolo_daya_tpu_torch.train.trainer import TrainState

    peaks = iter([5.0e9, 1.5e9])
    for name, fn in (("synchronize", lambda *a: None), ("empty_cache", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: next(peaks)),
                     ("memory_reserved", lambda *a: 4.0e9),
                     ("memory_allocated", lambda *a: 1.0e9)):
        monkeypatch.setattr(torch.cuda, name, fn)
    states, evals = [], []

    def make_state():
        states.append(TrainState(TrainConfig(model="yolo11n", imgsz=IMGSZ, amp=False,
                                             max_boxes=8), nc=NC, steps_per_epoch=10,
                                 device="cpu"))
        return states[-1]

    got = autobatch.probe_path_bytes(make_state, IMGSZ, B, 8, True,
                                     lambda st, *batch: evals.append(len(batch)))
    assert got == max(5.0e9, 4.0e9 + 1.5e9 - 1.0e9)
    assert states[0].updates == WARMUP_RUNS + 1 and evals == [5, 5]
    peaks = iter([7.0e9, 0.5e9])
    assert autobatch.probe_path_bytes(make_state, IMGSZ, B, 8, False, None) == 7.0e9
    assert states[1].updates == 1


# ---------------------------------------------------------------- device_augment=False


def test_host_augmentation_trains_streamed(tmp_path):
    """device_augment=False: no device cache; the loader's augmented epoch
    (mosaic, HSV, flips on the host), GT bucketed, a step a batch."""
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "host", data_yaml, device_augment=False)
    assert t.cfg.cache is False and not t._uses_device_cache()
    seen = []
    epoch = t.train_loader.epoch

    def spy(*a, **kw):
        for b in epoch(*a, **kw):
            seen.append(b.images.shape)
            yield b

    t.train_loader.epoch = spy
    result = t.train()
    assert seen == [(4, 64, 64, 3)] * 2 and t.state.updates == 2
    assert np.isfinite(float(t.state.loss_acc["cls_loss"])) > 0
    assert (result["save_dir"] / "weights" / "last.pt").exists()


@pytest.mark.parametrize("option", [
    dict(device_augment=False), dict(batch=-1), dict(steps_per_dispatch=4),
    dict(profile_steps=2), dict(remat=True), dict(async_ckpt=False)])
def test_options_are_accepted(tmp_path, option):
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "opt", data_yaml, **option)
    for k, v in option.items():
        if k != "batch":
            assert getattr(t.cfg, k) == v

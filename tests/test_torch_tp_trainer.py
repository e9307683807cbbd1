"""The port's tensor-parallel Trainer on the CPU: one epoch with
``device="1x2"`` over two CPU ranks (``DYD_CPU_DEVICES=2``, gloo; yolo11n's
eleven 256-channel convs sharded over the model axis) against the JAX
Trainer with ``device="1x2"`` on two of conftest's CPU devices (GSPMD
sharding by the JAX ``tp_param_shardings``), from the same weights on
tests/test_torch_port_trainer.py's dataset and config (2 steps of B = 4,
on-card augmentation, streamed: the JAX default on several devices), with
that file's tolerances; then rank 0's run directory and whole checkpoints,
and ``dryrun_multichip(4)`` on a 2 x 2 mesh."""

import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.api import YOLO
from deal_yolo_daya_tpu_torch.models import make_detector, state_dict_from_jax
from deal_yolo_daya_tpu_torch.parallel.dryrun import dryrun_multichip
from deal_yolo_daya_tpu_torch.train.trainer import (TrainConfig, Trainer, inference_state_dict,
                                                    load_checkpoint)
from tests.test_torch_port_trainer import (CSV_ATOL, DELTA_RTOL, LOSS_RTOL, METRIC_ATOL, NC,
                                           _config, _rows, _start_weights, _write_dataset)
from tests.torch_deadline import LIMIT, _deadline, _deadline_module  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads in this process, one a rank while two ranks run: the
    tier-1 run shares the cores among six workers, and spinning OpenMP
    threads of several processes starve one another."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from deal_yolo_daya_tpu.models.registry import make_detector as jax_make_detector
    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("tp_trainer")
    data_yaml = _write_dataset(tmp / "ds")
    model = jax_make_detector("yolo11", "n", NC, dtype=jnp.float32)
    start = _start_weights(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 128, 128, 3)), train=False))(jax.random.PRNGKey(0)))
    jt = JaxTrainer(_config(JaxTrainConfig, data_yaml, tmp / "jax", "run", device="1x2"),
                    init_variables=start)
    assert dict(jt.mesh.shape) == {"data": 1, "model": 2} and jt.cfg.cache is False
    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass_stats  # while the programs are traced
    try:
        jres = jt.train()
    finally:
        normalization._compute_stats = compute_stats

    saves = []
    save = Trainer.save_checkpoint
    saved_env = os.environ.get("DYD_CPU_DEVICES")
    os.environ["DYD_CPU_DEVICES"] = "2"
    Trainer.save_checkpoint = lambda self, tag, *a: (saves.append((self.rank, tag)),
                                                     save(self, tag, *a))[1]
    try:
        pt = Trainer(_config(TrainConfig, data_yaml, tmp / "port", "run", device="1x2",
                             extra={"dist_timeout_s": LIMIT / 2}),
                     init_state_dict=state_dict_from_jax(start))
        sharded = dict(pt.state.tp)
        pres = pt.train()
    finally:
        Trainer.save_checkpoint = save
        if saved_env is None:
            del os.environ["DYD_CPU_DEVICES"]
        else:
            os.environ["DYD_CPU_DEVICES"] = saved_env
    return {"jax": {"rows": _rows(jres["save_dir"]), "metrics": jres["metrics"],
                    "save_dir": Path(jres["save_dir"]),
                    "ema": state_dict_from_jax({"params": jax.device_get(jt.state.ema_params)}),
                    "initial": state_dict_from_jax(start)},
            "port": pt, "port_result": pres, "sharded": sharded, "saves": saves, "tmp": tmp}


def test_tp_results_csv_matches_jax(runs):
    (want,), (got,) = runs["jax"]["rows"], _rows(runs["port_result"]["save_dir"])
    assert list(got) == list(want)
    for col in want:
        if col in ("epoch", "time"):
            continue
        assert float(got[col]) == pytest.approx(float(want[col]), rel=LOSS_RTOL, abs=CSV_ATOL), col
    assert float(got["train/box_loss"]) > 0 and float(got["val/cls_loss"]) > 0


def test_tp_metrics_match_jax(runs):
    want, got = runs["jax"]["metrics"], runs["port_result"]["metrics"]
    for k in ("precision", "recall", "map50", "map"):
        assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k
    assert got["recall"] > 0
    np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"], atol=METRIC_ATOL)


def test_tp_ema_matches_jax(runs):
    """The EMA's move from the start weights, per tensor (whole, after the
    run)."""
    init, want = runs["jax"]["initial"], runs["jax"]["ema"]
    got = runs["port"].state.ema_state_dict()
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    eps = 4 * np.finfo(np.float32).eps
    for name, g in got.items():
        w = (want[name] - init[name]).numpy()
        d = (g - init[name]).numpy()
        floor = eps * float(np.abs(init[name].numpy()).max()) + 1e-9
        assert np.abs(d - w).max() <= DELTA_RTOL * np.abs(w).max() + floor, name


def test_tp_run_dir_and_whole_checkpoints(runs):
    """Rank 0 alone wrote last and best, once each, whole (the one-device
    keys and shapes); ``YOLO(best.pt)`` loads them as yolo11n; the run
    directory holds the JAX run's files; the Trainer is back on one device."""
    port = runs["port"]
    assert len(runs["sharded"]) == 11 and "23.cv3.2.0.0.conv.weight" in runs["sharded"]
    assert port.mesh.shape == {"data": 1, "model": 2} and port.rank == 0
    assert sorted(runs["saves"]) == [(0, "best"), (0, "last")]
    save_dir = Path(runs["port_result"]["save_dir"])
    assert sorted(p.name for p in (save_dir / "weights").iterdir()) == ["best.pt", "last.pt"]
    whole = {k: v.shape for k, v in make_detector("yolo11", "n", NC).state_dict().items()}
    ckpt = load_checkpoint(save_dir / "weights" / "best.pt")
    assert {k: v.shape for k, v in ckpt["model"].items()} == whole
    assert {k: v.shape for k, v in ckpt["ema"].items()} == {
        k: whole[k] for k, _ in make_detector("yolo11", "n", NC).named_parameters()}
    assert ckpt["updates"] == 2
    for k, v in port.state.state()["model"].items():
        assert torch.equal(ckpt["model"][k], v), k
    yolo = YOLO(str(save_dir / "weights" / "best.pt"), device="cpu")
    want = inference_state_dict(ckpt)
    for k, v in yolo._model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert port.state.dp is None and port.state.tp == {} and port._ranks is None
    assert sorted(p.name for p in save_dir.iterdir()) == \
        sorted(p.name for p in runs["jax"]["save_dir"].iterdir())


def test_dryrun_multichip_four_takes_two_by_two():
    """The JAX dry run's split: 4 devices -> a 2 x 2 mesh, the convs of 128
    channels and more sharded; every rank ends with the same whole
    parameters."""
    rec = dryrun_multichip(4)
    assert rec["mesh"] == (2, 2)
    assert [r["rank"] for r in rec["ranks"]] == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" for r in rec["ranks"])
    sharded = rec["ranks"][0]["sharded"]
    assert len(sharded) > 11 and all(r["sharded"] == sharded for r in rec["ranks"])
    assert len(set(rec["ranks"][0]["param_sums"])) == 1
    assert all(r["param_sums"] == rec["ranks"][0]["param_sums"] for r in rec["ranks"])
    assert rec["loss"]["cls_loss"] > 0


def test_training_page_thread_runs_tensor_parallel(tmp_path, monkeypatch):
    """The training page's call path (``run_yolo_training_stream`` in a
    worker thread, the page's kwargs) with the mesh field at "1x2" over two
    CPU devices: a tensor-parallel run of two ranks trains, and rank 0
    writes the run directory."""
    import queue
    import threading

    from deal_yolo_daya_tpu_torch.core.training import LOG_DONE, run_yolo_training_stream
    from tests.test_data import make_dataset

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "tools"))
    import synth_annotations_torch as synth

    monkeypatch.setenv("DYD_CPU_DEVICES", "2")
    data_yaml = make_dataset(tmp_path, n_train=4, n_val=2, imgsz=64, nc=2)
    kwargs = synth.page_train_kwargs(str(tmp_path / "runs"), "tp", epochs=1, imgsz=64,
                                     batch=4, device="1x2", dist_timeout_s=LIMIT / 2)
    log_queue: "queue.Queue" = queue.Queue()
    holder: dict = {}
    thread = threading.Thread(target=run_yolo_training_stream, daemon=True, args=(
        "yolo11n", str(data_yaml), kwargs, {}, log_queue, holder))
    thread.start()
    lines, end = [], time.monotonic() + LIMIT / 2
    while (item := log_queue.get(timeout=max(0.0, end - time.monotonic()))) is not LOG_DONE:
        lines.append(item)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert "error" not in holder, holder.get("error")
    assert any("ranks=2 mesh=1x2" in ln for ln in lines), lines
    assert any(ln.startswith("Epoch 1/1") for ln in lines), lines
    assert (Path(holder["save_dir"]) / "results.csv").exists()
